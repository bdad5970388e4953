"""Top-1 agreement of the bf16 kernel path with the f32 plain path on a
trained checkpoint, over its dev questions.

    python -m isubgvqa_tpu_torch.bf16_agreement \
        --ckpt outputdir/trainrun_torch/simple/checkpoint_top_res \
        [--set mgat_masks=0.3,1,0.5,0.15] [--device cpu]

Each batch runs the eval forward four times on the same weights and the
same sampler noise (a generator seeded from ``cfg.seed`` and the batch
index, made anew for each forward): the bf16 model through the kernels
and through the fused layers' plain versions, the f32 model through the
kernels and through the plain versions.  The f32 plain path is the
reference.  The bf16 plain path's own disagreement with it is what bf16
rounding alone does, with no kernel involved; the bf16 kernel path's
disagreements are held against that, in two ways that do not use the
kernel path's own error:

* how many of them the bf16 plain path shares (it too disagrees with
  the reference on that row);
* how many lie inside the rounding margin: the reference's top-1 leads
  its second answer by no more than twice the row's bf16 rounding error,
  the largest logit difference of the bf16 plain path from the
  reference on that row.

Also each path's accuracy, the bf16 kernel path's agreement with the
bf16 plain path, the f32 kernel path's largest logit difference from
the f32 plain path and the rows whose node mask differs.  On the CPU
every path is the plain version.

``--set field=value`` (or ``over``) changes the checkpoint's config, a
variant on the same weights; a variant whose parameters differ in name
or shape from the checkpoint's is not run, and the reason is returned.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Optional

import torch

from .config import Config
from .models.fused_sites import plain_layers


def _field(cfg: Config, name: str, value: str):
    """``value`` parsed as the type of ``cfg``'s field ``name``."""
    cur = getattr(cfg, name)
    if isinstance(cur, tuple):
        return tuple(float(v) for v in value.split(","))
    if isinstance(cur, bool):
        return value.lower() in ("1", "true", "yes")
    return type(cur)(value) if cur is not None else value


def compare(ref, plain16, kern16, rows) -> dict:
    """One batch's counts over the ``rows`` (a bool mask) of the logits
    ``[B, A]`` of the f32 plain path ``ref``, the bf16 plain path
    ``plain16`` and the bf16 kernel path ``kern16``: the rows where the
    kernels' and the bf16 plain path's top-1 agree with the reference's
    and with each other, and of the kernels' disagreements, those the
    bf16 plain path shares and those inside the rounding margin (the
    reference's top-1 leads by at most twice the row's largest
    ``|plain16 - ref|``)."""
    ref, plain16, kern16 = ref.float(), plain16.float(), kern16.float()
    top_r, top_p, top_k = (x.argmax(-1) for x in (ref, plain16, kern16))
    off_k = rows & (top_k != top_r)
    off_p = rows & (top_p != top_r)
    top2 = ref.topk(2, dim=-1).values
    rounding = (plain16 - ref).abs().max(-1).values
    n = int(rows.sum())
    return {"real": n,
            "agree_f32_plain": n - int(off_k.sum()),
            "also_bf16_plain": int((off_k & off_p).sum()),
            "inside_rounding": int((off_k & (top2[:, 0] - top2[:, 1]
                                             <= 2 * rounding)).sum()),
            "plain_bf16_agree_f32_plain": n - int(off_p.sum()),
            "agree_bf16_plain": int((rows & (top_k == top_p)).sum())}


def agreement(ckpt: str, device=None, over: Optional[dict] = None,
              say: Callable = print) -> dict:
    from .data import AnswerMap, SceneGraphVocab
    from .data.batching import iterate_batches_bucketed
    from .data.build import build_datasets
    from .models.build import build_model, make_aimle_states, resolve_device
    from .sampling.aimle import AIMLE_FIELDS
    from .serve import batch_seed

    device = resolve_device(device)
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    cfg = dataclasses.replace(Config.from_json(blob["config"]),
                              **(over or {}))
    sd = blob["state_dict"]
    vocab = SceneGraphVocab.build(cfg.meta_dir, glove_path=cfg.glove_path,
                                  seed=cfg.seed)
    cfg = dataclasses.replace(cfg, num_answers=len(
        AnswerMap.build(cfg.meta_dir, cfg.num_answers)))
    want = {k: tuple(v.shape) for k, v in sd.items()}
    m32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                      vocab, device)
    got = {k: tuple(v.shape) for k, v in m32.state_dict().items()}
    if got != want:
        differ = sorted(set(got) ^ set(want)) + sorted(
            k for k in set(got) & set(want) if got[k] != want[k])
        reason = (f"parameters differ from the checkpoint's in {len(differ)} "
                  f"tensors ({', '.join(differ[:3])}, ...)")
        say(f"skipped: {reason}")
        return {"skipped": reason}
    m32.load_state_dict(sd)
    m16 = build_model(cfg, vocab, device, state_dict=sd)
    data = build_datasets(cfg)
    states = make_aimle_states(cfg, device)
    if states is not None and blob.get("aimle_states"):
        with torch.no_grad():
            for i, st in states.items():
                for f in AIMLE_FIELDS:
                    getattr(st, f).copy_(blob["aimle_states"][str(i)][f])

    def forward(model, batch, plain, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        with plain_layers(plain), torch.no_grad():
            return model(batch, generator=gen, aimle_states=states)

    res = {"real": 0, "agree_f32_plain": 0, "also_bf16_plain": 0,
           "inside_rounding": 0, "plain_bf16_agree_f32_plain": 0,
           "agree_bf16_plain": 0, "node_mask_rows": 0,
           "f32_kernel_max_abs": 0.0, "logit_scale": 0.0, "batches": 0}
    correct = {"bf16_kernels": 0, "bf16_plain": 0, "f32_plain": 0}
    for b_idx, (batch, _) in enumerate(iterate_batches_bucketed(
            data.datasets["dev"], data.bucket_collators["dev"])):
        batch = batch.to(device)
        seed = batch_seed(cfg.seed, 1 << 20, b_idx)
        k16 = forward(m16, batch, False, seed)
        p16 = forward(m16, batch, True, seed).logits
        k32 = forward(m32, batch, False, seed).logits
        p32 = forward(m32, batch, True, seed)
        rows = batch.sample_mask > 0
        for key, n in compare(p32.logits, p16, k16.logits, rows).items():
            res[key] += n
        res["node_mask_rows"] += int(
            (k16.node_mask.round() != p32.node_mask.round())
            .any(1)[..., 0][rows].sum())
        res["f32_kernel_max_abs"] = max(
            res["f32_kernel_max_abs"], (k32 - p32.logits).abs().max().item())
        res["logit_scale"] = max(res["logit_scale"],
                                 p32.logits[rows].abs().max().item())
        for name, x in (("bf16_kernels", k16.logits), ("bf16_plain", p16),
                        ("f32_plain", p32.logits)):
            correct[name] += int(((x.argmax(-1) == batch.labels.long())
                                  & rows).sum())
        res["batches"] += 1
    res["accuracy"] = {name: 100.0 * c / max(res["real"], 1)
                       for name, c in correct.items()}
    say(json.dumps(res))
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m isubgvqa_tpu_torch.bf16_agreement")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--set", nargs="*", default=[], metavar="FIELD=VALUE",
                   help="config fields changed on the checkpoint's weights")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)
    base = Config()
    over = {}
    for item in args.set:
        name, value = item.split("=", 1)
        over[name] = _field(base, name, value)
    return agreement(args.ckpt, args.device, over,
                     say=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
