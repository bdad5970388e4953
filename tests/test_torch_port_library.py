"""The library yardsticks of the question stack's layers against the
plain layers, in f32 on the CPU.

``encoder_layer_library`` and ``decoder_layer_library`` build
``nn.TransformerEncoderLayer`` / ``nn.TransformerDecoderLayer`` from the
port's parameter dicts; ``chip_smoke.py`` times them beside the port's
kernels as the one PyTorch call that computes the same function.  These
tests show that it is the same function: a padded question (the CLIP key
mask ADDED to the logits, which the MHA fast path would misread as a
padding mask), and the decoder's cross-attention to every memory token.
Tolerance 1e-5 abs: both sides run f32 products, only the order of the
sums differs (observed ~1e-6).
"""

import numpy as np
import pytest
import torch

from isubgvqa_tpu_torch.ops import text_kernel as T

from test_torch_port_model import one_torch_thread  # noqa: F401

B, L, TQ, D, H, FF = 3, 8, 4, 64, 8, 128
ATOL = 1e-5


def _params(keys, seed):
    """Seeded weights in torch Linear layout, biases and LayerNorm
    vectors away from their init so that every slot is exercised."""
    rng = np.random.default_rng(seed)
    shapes = {"in_w": (3 * D, D), "out_w": (D, D), "w1": (FF, D),
              "w2": (D, FF), "in_b": (3 * D,), "out_b": (D,), "b1": (FF,),
              "b2": (D,)}
    out = {}
    for k in keys:
        base = k.split("_", 1)[1] if k[:2] in ("s_", "c_") else k
        if base.startswith("n") and base.endswith("s"):
            a = 1.0 + 0.1 * rng.standard_normal(D)
        elif base.startswith("n") and base.endswith("b"):
            a = 0.1 * rng.standard_normal(D)
        else:
            shape = shapes[base]
            a = rng.standard_normal(shape) / np.sqrt(shape[-1])
        out[k] = torch.tensor(a, dtype=torch.float32)
    return out


def _key_mask(padded):
    m = np.ones((B, L), np.float32)
    if padded:
        m[0, 5:] = 0.0
        m[2, 3:] = 0.0
    return torch.from_numpy(m)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
def test_encoder_library_matches_plain(padded):
    p = _params(T.ENC_KEYS, 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, L, D)).astype(np.float32))
    km = _key_mask(padded)
    want = T.fused_encoder_layer_plain(x, km, p, H)
    with torch.no_grad():
        got = T.encoder_layer_library(p, H)(x, km)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= ATOL


def test_decoder_library_matches_plain_with_cross_attention():
    p = _params(T.DEC_KEYS, 2)
    rng = np.random.default_rng(3)
    tgt = torch.from_numpy(rng.standard_normal((B, TQ, D)).astype(np.float32))
    mem = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    want = T.fused_decoder_layer_plain(tgt, mem, p, H)
    with torch.no_grad():
        got = T.decoder_layer_library(p, H)(tgt, mem)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= ATOL


def test_library_runs_with_the_fast_path_off_and_restores_it():
    """In eval mode the MHA fast path would read the additive key mask as
    a padding mask; the yardstick turns it off for its call only."""
    p = _params(T.ENC_KEYS, 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, L, D)).astype(np.float32))
    km = _key_mask(True)
    run = T.encoder_layer_library(p, H)
    assert torch.backends.mha.get_fastpath_enabled()
    with torch.no_grad():
        got = run(x, km)
    assert torch.backends.mha.get_fastpath_enabled()
    want = T.fused_encoder_layer_plain(x, km, p, H)
    assert (got - want).abs().max().item() <= ATOL
