"""``cfg.clip_weights`` in the port: a fresh train state starts its
question encoder's token and position tables from the pretrained CLIP
tables, exactly as the JAX package's ``create_train_state`` does.

The same ``.npz`` and torch ``.pth`` files go through the JAX package's
``load_clip_text_tables`` + ``apply_clip_text_tables`` (on the question
encoder's subtree of a params tree, which is all that function touches)
and through the port's ``create_train_state`` on the CPU; the tables
must agree bit for bit.  A table of the wrong shape raises on both
sides, and a file without the tables raises in the port's loader.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from isubgvqa_tpu.convert import load_clip_text_tables as jax_load
from isubgvqa_tpu.models.build import apply_clip_text_tables as jax_apply
from isubgvqa_tpu_torch.config import Config
from isubgvqa_tpu_torch.convert import load_clip_text_tables
from isubgvqa_tpu_torch.data import SceneGraphVocab
from isubgvqa_tpu_torch.train import create_train_state

from test_torch_port_model import one_torch_thread  # noqa: F401
from test_torch_port_model import quick_xla  # noqa: F401

VOCAB, D, POS = 512, 64, 77


def small_cfg(**kw):
    # narrow widths: the tables are all that is compared
    base = dict(num_answers=32, text_vocab_size=VOCAB, question_len=12,
                text_emb_dim=D, general_hidden_dim=32, encoder_layers=1,
                decoder_layers=1,
                max_nodes_per_graph=32, max_edges_per_graph=128,
                batch_size=4, compute_dtype="float32", sampler_type="gumbel",
                sample_k=3, mgat_masks=(1.0, 1.0, 1.0, 0.15), meta_dir="")
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(17)
    return {"token_embedding": rng.normal(size=(VOCAB, D)).astype(np.float32),
            "position_embedding": rng.normal(size=(POS, D)).astype(
                np.float32)}


def _files(tables, tmp_path):
    npz = tmp_path / "clip_text.npz"
    np.savez(npz, **tables)
    pth = tmp_path / "ref_ckpt.pth"
    torch.save({"model": {
        f"module.text_vocab_embedding.{k}.weight": torch.from_numpy(v)
        for k, v in tables.items()}, "epoch": 3}, pth)
    return {"npz": str(npz), "pth": str(pth)}


def _jax_tables(path, shapes):
    params = {"question_encoder": {"text_vocab_embedding": {
        k: {"embedding": jnp.zeros(s, jnp.float32)}
        for k, s in shapes.items()}}}
    emb = jax_apply(params, jax_load(path))["question_encoder"][
        "text_vocab_embedding"]
    return {k: np.asarray(emb[k]["embedding"]) for k in shapes}


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_train_state_tables_equal_jax(tables, tmp_path, fmt):
    path = _files(tables, tmp_path)[fmt]
    cfg = small_cfg(clip_weights=path)
    state = create_train_state(cfg, SceneGraphVocab.synthetic(),
                               steps_per_epoch=4, device="cpu")
    emb = state.model.text_vocab_embedding
    port = {k: getattr(emb, k).weight.detach().numpy()
            for k in ("token_embedding", "position_embedding")}
    want = _jax_tables(path, {k: v.shape for k, v in port.items()})
    for k in port:
        np.testing.assert_array_equal(port[k], want[k])
        np.testing.assert_array_equal(port[k], tables[k])
    # without the field the tables stay the seeded random init
    plain = create_train_state(small_cfg(), SceneGraphVocab.synthetic(),
                               steps_per_epoch=4, device="cpu")
    assert not np.allclose(
        plain.model.text_vocab_embedding.token_embedding.weight.detach()
        .numpy(), tables["token_embedding"])


def test_wrong_shape_raises(tables, tmp_path):
    bad = dict(tables, token_embedding=tables["token_embedding"][:, :D // 2])
    path = _files(bad, tmp_path)["npz"]
    with pytest.raises(ValueError, match="does not match"):
        create_train_state(small_cfg(clip_weights=path),
                           SceneGraphVocab.synthetic(), steps_per_epoch=4,
                           device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        _jax_tables(path, {"token_embedding": (VOCAB, D),
                           "position_embedding": (POS, D)})


def test_missing_tables_raise(tmp_path):
    path = tmp_path / "wrong.npz"
    np.savez(path, foo=np.zeros((2, 2), np.float32))
    with pytest.raises(KeyError, match="CLIP text-embedding"):
        load_clip_text_tables(str(path))


def test_hf_names_and_dataclass_field(tables, tmp_path):
    """HuggingFace CLIPModel names load too, and the field is part of the
    port's config as of the JAX package's."""
    path = tmp_path / "clip_model.pt"
    torch.save({f"text_model.embeddings.{k}.weight": torch.from_numpy(v)
                for k, v in tables.items()}, path)
    got = load_clip_text_tables(str(path))
    np.testing.assert_array_equal(got["position_embedding"].numpy(),
                                  tables["position_embedding"])
    assert "clip_weights" in {f.name for f in dataclasses.fields(Config)}
