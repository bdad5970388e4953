"""The port's library ops against the JAX package's, function by
function, on seeded numpy inputs on the CPU: ``ops/segment.py``,
``ops/dense.py``, ``ops/dense_graph.py``, ``ops/topk_ratio.py``,
``sampling/rewiring.py`` and the flat ``node_mask_to_edge_mask``
(forward, and its dst-only backward against ``jax.vjp``).

The inputs hold what the index rules decide: ids and positions out of
range (negative and past the end), empty segments, masked entries and
tied scores.  One parametrised test per module, one case per function
and input variant.

Tolerances: masks, indices and integer outputs exact; f32 outputs
within 1e-6 (relative, and absolute near 0: the two packages sum in
another order); NaN where JAX's gather fills with NaN, on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from isubgvqa_tpu.ops import dense as jdense
from isubgvqa_tpu.ops import dense_graph as jdg
from isubgvqa_tpu.ops import segment as jseg
from isubgvqa_tpu.ops import topk_ratio as jtopk
from isubgvqa_tpu.sampling import node_edge as jne
from isubgvqa_tpu.sampling import rewiring as jrew
from isubgvqa_tpu_torch import ops as tops
from isubgvqa_tpu_torch import sampling as tsampling
from isubgvqa_tpu_torch.ops import dense as tdense
from isubgvqa_tpu_torch.ops import dense_graph as tdg
from isubgvqa_tpu_torch.ops import segment as tseg
from isubgvqa_tpu_torch.ops import topk_ratio as ttopk
from isubgvqa_tpu_torch.sampling import node_edge as tne
from isubgvqa_tpu_torch.sampling import rewiring as trew

from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

TOL = 1e-6


def check(got, want):
    """Every output of the port against JAX's: exact for bool and integer
    arrays, within ``TOL`` for floats (NaN matching NaN)."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            check(g, w)
        return
    if want is None:
        assert got is None
        return
    w = np.asarray(want)
    g = got.detach().float().numpy() if got.dtype == torch.bfloat16 \
        else got.detach().numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w.astype(np.float32), rtol=TOL,
                                   atol=TOL)


def pair(a):
    """A numpy array as (torch tensor, jax array)."""
    a = np.asarray(a)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


# ------------------------------------------------------------- segment

S = 6                       # segments; segment 4 is empty


def segment_inputs(rng):
    e = 40
    ids = rng.integers(-2, S + 3, e).astype(np.int32)
    ids[ids == 4] = 3
    data = np.round(rng.normal(size=(e, 3)), 1).astype(np.float32)  # ties
    mask = rng.random(e) < 0.7
    return ids, data, mask


SEGMENT_CASES = [(fn, masked) for fn in ("sum", "count", "mean", "max",
                                         "min", "softmax", "normalize",
                                         "normalize_alpha")
                 for masked in (False, True)]


@pytest.mark.parametrize("fn,masked", SEGMENT_CASES,
                         ids=[f"{f}-{'mask' if m else 'nomask'}"
                              for f, m in SEGMENT_CASES])
def test_segment_matches_jax(fn, masked):
    ids, data, mask = segment_inputs(np.random.default_rng(0))
    (ti, ji), (td, jd) = pair(ids), pair(data)
    tm, jm = pair(mask) if masked else (None, None)
    if fn == "count":
        got = tseg.segment_count(ti, S, tm)
        want = jseg.segment_count(ji, S, jm)
    elif fn.startswith("normalize"):
        alpha = np.array([0.5, 1.0, 1.5], np.float32)
        ta, ja = pair(alpha) if fn.endswith("alpha") else (None, None)
        got = tseg.segment_normalize(td, ti, S, tm, ta)
        want = jseg.segment_normalize(jd, ji, S, jm, ja)
    else:
        got = getattr(tseg, f"segment_{fn}")(td, ti, S, tm)
        want = getattr(jseg, f"segment_{fn}")(jd, ji, S, jm)
    check(got, want)
    if fn in ("max", "min"):             # the empty segment reads initial
        assert abs(float(got[4, 0])) == float(np.float32(1e30))


def test_segment_ops_are_exported_as_in_jax():
    """The names the JAX ``ops`` and ``sampling`` packages export."""
    for name in ("segment_sum", "segment_mean", "segment_max", "segment_min",
                 "segment_softmax", "segment_normalize", "to_dense_batch",
                 "from_dense_batch", "dense_topk_mask"):
        assert name in tops.__all__ and callable(getattr(tops, name))
    for name in ("node_mask_to_edge_mask", "dense_node_gate_to_edge_gate",
                 "batch_repeat_edge_index",
                 "batched_edge_index_to_batched_adj", "masked_softmax",
                 "non_merge_coalesce", "rewire_global_directed",
                 "rewire_global_undirected", "weighted_cross_entropy"):
        assert name in tsampling.__all__
        assert callable(getattr(tsampling, name))


# --------------------------------------------------------------- dense

B, NMAX = 5, 7


def dense_inputs(rng):
    """Flat nodes of B graphs (graph 2 empty), unique positions in each,
    then padding rows at ids B (the padding id), B + 3 and -1 (both land
    on the extra row) and -(B + 3) (dropped)."""
    sizes = [3, 7, 0, 5, 2]
    seg = np.concatenate([np.full(n, g) for g, n in enumerate(sizes)])
    pos = np.concatenate([rng.permutation(NMAX)[:n] for n in sizes])
    seg = np.concatenate([seg, [B, B, B + 3, -1, -(B + 3)]]).astype(np.int32)
    pos = np.concatenate([pos, [0, 9, 2, -4, 1]]).astype(np.int32)
    flat = np.round(rng.normal(size=(len(seg), 2)), 1).astype(np.float32)
    return seg, pos, flat


DENSE_CASES = ("to_dense", "to_dense_fill", "to_dense_1d", "from_dense",
               "from_dense_valid", "topk_k2", "topk_all")


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_matches_jax(case):
    rng = np.random.default_rng(1)
    seg, pos, flat = dense_inputs(rng)
    (ts, js), (tp, jp) = pair(seg), pair(pos)
    if case.startswith("to_dense"):
        x = flat[:, 0] if case.endswith("1d") else flat
        fill = -1.0 if case.endswith("fill") else 0.0
        tx, jx = pair(x)
        check(tdense.to_dense_batch(tx, ts, tp, B, NMAX, fill),
              jdense.to_dense_batch(jx, js, jp, B, NMAX, fill))
    elif case.startswith("from_dense"):
        dense = rng.normal(size=(B, NMAX, 2)).astype(np.float32)
        td, jd = pair(dense)
        valid = (seg >= 0) & (seg < B) if case.endswith("valid") else None
        tv, jv = pair(valid) if valid is not None else (None, None)
        check(tdense.from_dense_batch(td, ts, tp, tv),
              jdense.from_dense_batch(jd, js, jp, jv))
    else:
        scores = np.round(rng.normal(size=(B, NMAX)), 0).astype(np.float32)
        k = 2 if case == "topk_k2" else NMAX
        tsc, jsc = pair(scores)
        check(tdense.dense_topk_mask(tsc, k), jdense.dense_topk_mask(jsc, k))


# --------------------------------------------------------- dense_graph

BG, N, E, F, H = 3, 6, 10, 4, 2


def graph_inputs(rng):
    node_mask = np.ones((BG, N), bool)
    node_mask[0, 4:] = False
    node_mask[2, :] = False                  # an empty graph
    edge_mask = rng.random((BG, E)) < 0.8
    src = rng.integers(0, N, (BG, E)).astype(np.int32)
    dst = rng.integers(0, N, (BG, E)).astype(np.int32)
    dst[1, :3] = 2                           # three edges into one node
    x = np.round(rng.normal(size=(BG, N, F)), 1).astype(np.float32)
    logits = np.round(rng.normal(size=(BG, E, H)), 1).astype(np.float32)
    return node_mask, edge_mask, src, dst, x, logits


DENSE_GRAPH_CASES = ("edge_onehot", "edge_onehot_masked", "edge_onehot_oob",
                     "gather_take", "gather_take_oob", "gather_onehot",
                     "gather_nodes_oh", "aggregate_edges", "edge_softmax",
                     "edge_softmax_nomask", "edge_softmax_oob",
                     "node_softmax", "masked_mean", "masked_mean_nomask",
                     "graph_norm_dense")


@pytest.mark.parametrize("case", DENSE_GRAPH_CASES)
def test_dense_graph_matches_jax(case):
    rng = np.random.default_rng(2)
    node_mask, edge_mask, src, dst, x, logits = graph_inputs(rng)
    if case.endswith("oob"):                 # past the end, and negative
        src[0, :2] = (N, -1)
        dst[0, :3] = (N + 2, -1, -(N + 1))
    (tnm, jnm), (tem, jem) = pair(node_mask), pair(edge_mask)
    (tsrc, jsrc), (tdst, jdst) = pair(src), pair(dst)
    (tx, jx), (tl, jl) = pair(x), pair(logits)
    if case.startswith("edge_onehot"):
        tm, jm = (tem, jem) if case.endswith("masked") else (None, None)
        check(tdg.edge_onehot(tdst, N, tm), jdg.edge_onehot(jdst, N, jm))
        check(tdg.edge_onehot(tsrc, N, tm, dtype=torch.float32),
              jdg.edge_onehot(jsrc, N, jm, dtype=jnp.float32))
    elif case.startswith("gather_take"):
        check(tdg.gather_nodes(tx, tsrc), jdg.gather_nodes(jx, jsrc))
    elif case == "gather_onehot":
        check(tdg.gather_nodes(tx, tsrc, via="onehot"),
              jdg.gather_nodes(jx, jsrc, via="onehot"))
    elif case == "gather_nodes_oh":
        oh = (src[..., None] == np.arange(N)) * edge_mask[..., None]
        toh, joh = pair(oh.astype(np.float32))
        check(tdg.gather_nodes_oh(tx, toh), jdg.gather_nodes_oh(jx, joh))
    elif case == "aggregate_edges":
        msg = rng.normal(size=(BG, E, F)).astype(np.float32)
        (tmsg, jmsg), (toh, joh) = pair(msg), pair(
            ((dst[..., None] == np.arange(N)) * edge_mask[..., None]
             ).astype(np.float32))
        check(tdg.aggregate_edges(tmsg, toh), jdg.aggregate_edges(jmsg, joh))
    elif case.startswith("edge_softmax"):
        tm, jm = (None, None) if case.endswith("nomask") else (tem, jem)
        em = edge_mask if tm is not None else np.ones_like(edge_mask)
        (toh, joh) = pair(((dst[..., None] == np.arange(N)) * em[..., None]
                           ).astype(np.float32))
        check(tdg.edge_softmax(tl, tdst, toh, tm),
              jdg.edge_softmax(jl, jdst, joh, jm))
    elif case == "node_softmax":
        check(tdg.node_softmax(tx[..., 0], tnm),
              jdg.node_softmax(jx[..., 0], jnm))
    elif case.startswith("masked_mean"):
        tm, jm = (None, None) if case.endswith("nomask") else (tnm, jnm)
        check(tdg.masked_mean(tx, tm, axis=1),
              jdg.masked_mean(jx, jm, axis=1))
        check(tdg.masked_mean(tx, tm, axis=1, keepdims=True),
              jdg.masked_mean(jx, jm, axis=1, keepdims=True))
    else:
        w, b, ms = (rng.normal(size=F).astype(np.float32) for _ in range(3))
        (tw, jw), (tb, jb), (tms, jms) = pair(w), pair(b), pair(ms)
        got = tdg.graph_norm_dense(tx, tnm, tw, tb, tms)
        check(got, jdg.graph_norm_dense(jx, jnm, jw, jb, jms))
        # the same math as segment_normalize on the flat layout
        flat_ids = np.repeat(np.arange(BG), N).astype(np.int32)
        norm, _, _ = tseg.segment_normalize(
            tx.reshape(BG * N, F), torch.from_numpy(flat_ids), BG,
            tnm.reshape(-1), tms)
        want = torch.where(tnm.reshape(-1, 1), norm * tw + tb,
                           tb.expand(BG * N, F))
        np.testing.assert_allclose(got.reshape(BG * N, F).numpy(),
                                   want.numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------- topk_ratio

TOPK_CASES = ("ratio_half", "ratio_small", "k_int", "k_float_above_one",
              "k_past_nodes")


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_per_graph_matches_jax(case):
    rng = np.random.default_rng(3)
    scores = np.round(rng.normal(size=(4, 9)), 0).astype(np.float32)  # ties
    node_mask = np.ones((4, 9), bool)
    node_mask[1, 5:] = False
    node_mask[3, :] = False                   # an empty graph
    arg = {"ratio_half": 0.5, "ratio_small": 0.3, "k_int": 2,
           "k_float_above_one": 3.0, "k_past_nodes": 7}[case]
    (ts, js), (tm, jm) = pair(scores), pair(node_mask)
    got = ttopk.topk_per_graph(ts, arg, tm)
    check(got, jtopk.topk_per_graph(js, arg, jm))
    assert float(got[3].sum()) == 0.0


# ------------------------------------------------------------ rewiring

REWIRING_CASES = ("directed", "directed_adj", "undirected",
                  "undirected_adj", "masked_softmax", "masked_softmax_axis1",
                  "weighted_ce", "weighted_ce_zero_weights", "batched_adj",
                  "coalesce_flat", "coalesce_batched_masked",
                  "coalesce_by_col_attrs", "repeat_once", "repeat_three")


@pytest.mark.parametrize("case", REWIRING_CASES)
def test_rewiring_matches_jax(case):
    rng = np.random.default_rng(4)
    b, n, e = 2, 5, 3
    adj = rng.random((b, n, n)) < 0.3
    if case.startswith(("directed", "undirected")):
        scores = np.round(rng.normal(size=(b, n, n, e)), 0).astype(np.float32)
        name = f"rewire_global_{case.split('_')[0]}"
        a = adj if case.endswith("adj") else None
        (ts, js) = pair(scores)
        ta, ja = pair(a) if a is not None else (None, None)
        check(getattr(trew, name)(ts, 4, ta), getattr(jrew, name)(js, 4, ja))
    elif case.startswith("masked_softmax"):
        logits = rng.normal(size=(3, 6)).astype(np.float32)
        mask = (rng.random((3, 6)) < 0.6).astype(np.float32)
        mask[2] = 0                           # a fully masked row
        axis = 1 if case.endswith("axis1") else -1
        (tl, jl), (tm, jm) = pair(logits), pair(mask)
        check(trew.masked_softmax(tl, tm, axis),
              jrew.masked_softmax(jl, jm, axis))
    elif case.startswith("weighted_ce"):
        logits = rng.normal(size=(6, 5)).astype(np.float32)
        labels = rng.integers(0, 5, 6).astype(np.int32)
        weights = (np.zeros(6) if case.endswith("zero_weights")
                   else rng.random(6)).astype(np.float32)
        (tl, jl), (tlab, jlab), (tw, jw) = pair(logits), pair(labels), \
            pair(weights)
        check(trew.weighted_cross_entropy(tl, tlab, tw),
              jrew.weighted_cross_entropy(jl, jlab, jw))
    elif case == "batched_adj":
        ne = 8
        src = rng.integers(0, n, (b, ne)).astype(np.int32)
        dst = rng.integers(0, n, (b, ne)).astype(np.int32)
        src[0, 0] = dst[0, 0] = 1             # an existing self-loop
        em = rng.random((b, ne)) < 0.8
        nm = np.ones((b, n), bool)
        nm[1, 3:] = False
        args = [pair(v) for v in (src, dst, em, nm)]
        check(trew.batched_edge_index_to_batched_adj(*(t for t, _ in args)),
              jrew.batched_edge_index_to_batched_adj(*(j for _, j in args)))
    elif case.startswith("coalesce"):
        batched = "batched" in case
        shape = (b, 9) if batched else (9,)
        src = rng.integers(0, n, shape).astype(np.int32)
        dst = rng.integers(0, n, shape).astype(np.int32)
        src[..., 1], dst[..., 1] = src[..., 0], dst[..., 0]   # a duplicate
        attr = rng.normal(size=shape + (2,)).astype(np.float32)
        weight = rng.normal(size=shape).astype(np.float32)
        em = rng.random(shape) < 0.7 if "masked" in case else None
        by_row = "by_col" not in case
        ta, ja = pair(attr) if "attrs" in case else (None, None)
        tw, jw = pair(weight)
        tem, jem = pair(em) if em is not None else (None, None)
        (tsrc, jsrc), (tdst, jdst) = pair(src), pair(dst)
        check(trew.non_merge_coalesce(tsrc, tdst, ta, tw, n, tem, by_row),
              jrew.non_merge_coalesce(jsrc, jdst, ja, jw, n, jem, by_row))
    else:
        ei = rng.integers(0, n, (2, 7)).astype(np.int32)
        reps = 1 if case == "repeat_once" else 3
        (t, j) = pair(ei)
        check(trew.batch_repeat_edge_index(t, n, reps),
              jrew.batch_repeat_edge_index(j, n, reps))


# ------------------------------------------------------------ node_edge

NODE_EDGE_CASES = ("column", "vector", "out_of_range")


@pytest.mark.parametrize("case", NODE_EDGE_CASES)
def test_node_mask_to_edge_mask_matches_jax(case):
    """Forward values, and the backward against ``jax.vjp`` of the JAX
    ``custom_vjp``: the cotangent summed to destinations only."""
    rng = np.random.default_rng(5)
    n, e = 7, 12
    mask = rng.random((n,) if case == "vector" else (n, 1)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if case == "out_of_range":
        src[:2] = (n + 1, -2)
        dst[:3] = (n, -1, -(n + 3))
    g = rng.normal(size=(e,) + mask.shape[1:]).astype(np.float32)
    (tm, jm), (ts, js), (td, jd) = pair(mask), pair(src), pair(dst)
    want, vjp = jax.vjp(lambda m: jne.node_mask_to_edge_mask(m, js, jd, n),
                        jm)
    tm.requires_grad_(True)
    got = tne.node_mask_to_edge_mask(tm, ts, td, n)
    check(got, want)
    got.backward(torch.from_numpy(g))
    check(tm.grad, vjp(jnp.asarray(g))[0])
    assert tm.grad.shape == tm.shape
