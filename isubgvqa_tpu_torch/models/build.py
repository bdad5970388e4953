"""Model construction (the port of ``isubgvqa_tpu/models/build.py``)."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..config import Config
from ..sampling import AIMLEState, init_aimle_state
from .isubgvqa import DTYPES, ISubGVQA


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; with no CUDA
    device and none asked for, raise rather than fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def check_supported(cfg: Config, device=None) -> None:
    """The port runs the eval forward and the training step under each
    of the four samplers and every model variant of the JAX package
    (``text_sampling``, ``use_all_instrs``, ``concat_instr``,
    ``use_global_mask``, ``interpretable_mode``, ``node_classification``,
    ``use_instruction`` or ``use_topk`` off, any masked layers).  On a
    CUDA device the kernels always run: ``use_pallas=False`` there is an
    error."""
    if device is not None and torch.device(device).type == "cuda" \
            and not cfg.use_pallas:
        raise ValueError("use_pallas=False: on a CUDA device the port "
                         "always runs its CUDA kernels")


def build_model(cfg: Config, vocab, device=None,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: Optional[int] = None,
                train: bool = False) -> ISubGVQA:
    """An :class:`ISubGVQA` on ``device`` computing at
    ``cfg.compute_dtype``.  Weights come from ``state_dict`` (upstream
    names, f32) or a seeded random init (``cfg.seed`` by default); the
    scene-graph table starts from ``vocab.vectors`` as in the JAX
    package.  An eval model (the default) ships its weight matrices at
    the compute dtype and needs no gradients; with ``train`` the
    parameters stay f32 masters with ``requires_grad``."""
    dev = resolve_device(device)
    check_supported(cfg, dev)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        model = ISubGVQA(cfg, sg_vocab_size=len(vocab),
                         sg_vocab_vectors=vocab.vectors)
    if state_dict is not None:
        model.load_state_dict(dict(state_dict), strict=True)
    model = model.to(dev)
    if train:
        return model.train()
    model.eval().cast_(DTYPES[cfg.compute_dtype])
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def apply_clip_text_tables(model: ISubGVQA, tables) -> None:
    """Overwrite the question encoder's token and position tables with
    the pretrained CLIP tables of :func:`..convert.load_clip_text_tables`
    (the port of ``isubgvqa_tpu/models/build.py:apply_clip_text_tables``;
    in place).  A table of another shape raises."""
    emb = model.text_vocab_embedding
    for name in ("token_embedding", "position_embedding"):
        dst = getattr(emb, name).weight
        src = torch.as_tensor(tables[name], dtype=torch.float32)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"pretrained CLIP {name} shape {tuple(src.shape)} does not "
                f"match the model's table {tuple(dst.shape)}: check "
                f"text_vocab_size / question-position config")
        with torch.no_grad():
            dst.copy_(src.to(dst.dtype))


def make_aimle_states(cfg: Config,
                      device=None) -> Optional[Dict[int, AIMLEState]]:
    """One AIMLE state per masked layer (threshold != 1.0), keyed by the
    layer's index, on ``device`` (the card unless the caller asks for
    another); ``None`` for the other samplers (the port of
    ``isubgvqa_tpu/models/build.py:make_aimle_states``)."""
    if cfg.sampler_type != "aimle":
        return None
    dev = resolve_device(device)
    return {i: init_aimle_state(dev)
            for i, t in enumerate(cfg.mgat_masks) if float(t) != 1.0}
