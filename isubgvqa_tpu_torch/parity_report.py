"""One-command parity report of the port on an upstream checkpoint (the
counterpart of ``scripts/parity_report.py``)::

    python -m isubgvqa_tpu_torch.parity_report \\
        --torch_ckpt /path/checkpoint_lowest_val_loss.pth \\
        --data_dir /path/GQA --meta_src /path/ISubGVQA/meta_info \\
        --clip_tokenizer_dir /path/clip_tok \\
        --reference_json ref_run_metrics.json --out parity_report \\
        [--device cpu]

Given GQA, the eight meta-info assets and an upstream ``.pth`` (the
reference's ``run_token_coo.py:23-45`` inputs), it

1. copies ``--meta_src`` into ``<work_dir>/meta_info`` (a local
   directory; nothing is fetched) and validates the assets (the port's
   copy of ``tools/fetch_meta_assets.py:validate``);
2. loads the ``.pth`` directly (the port keeps the upstream names, so no
   orbax step), its config derived from the checkpoint's ``args`` by the
   JAX converter's rule (:func:`~.convert.config_from_reference_args`),
   then ``--set`` overrides;
3. runs the batched eval and the token-co-occurrence metrics on the
   split on the card (``--device`` names another), through the CUDA
   kernels (:func:`~.explain.run_token_coo_exp`, the reference's
   ``run_token_coo.py:145-185`` metric surface), collecting each
   question's node mask;
4. compares the masks with a recorded reference run
   (``--reference_masks``, an npz of qid -> mask) and the metrics with
   recorded numbers (``--reference_json``);
5. writes ``<out>.json`` and ``<out>.md`` with the keys of the JAX
   package's report, so the two can be diffed.

Caveat recorded in the report: the reference evaluates its discrete
samplers with noise (masking calls the sampler forward at eval), so a
masked configuration's mask overlap and co-occurrence metrics carry
sampler-seed variance on both sides; answer accuracy of unmasked
configurations is deterministic.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

METRIC_KEYS = ("accuracy", "accuracy_at", "ans_token_coo",
               "qst_token_coo", "text_token_coo")

# (filename, kind, the entry count the reference documents)
META_ASSETS = (
    ("name_gqa.txt", "txt", 1703),
    ("attr_gqa.txt", "txt", 618),
    ("rel_gqa.txt", "txt", 311),
    ("objects.json", "json_list", 600),
    ("predicates.json", "json_list", 121),
    ("attributes.json", "json_list", 369),
    ("trainval_ans2label.json", "json_dict", 1842),
    ("trainval_label2ans.json", "json_list", 1842),
)


def validate_meta_assets(dst: str, strict_counts: bool = False) -> list:
    """The eight meta-info assets in ``dst``: returns warnings (entry
    counts other than the reference documents) and raises on structural
    faults (a missing file, an empty vocabulary list, a wrong JSON type,
    answer maps that are not a bijection)."""
    warnings = []
    for name, kind, want in META_ASSETS:
        path = os.path.join(dst, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"missing asset: {path}")
        with open(path) as f:
            if kind == "txt":
                n = sum(1 for r in f.read().splitlines() if r.strip())
                if not n:
                    raise ValueError(f"{name}: empty vocab list")
            else:
                obj = json.load(f)
                if not isinstance(obj, list if kind == "json_list" else dict):
                    raise ValueError(f"{name}: expected a JSON "
                                     f"{kind.split('_')[1]}")
                n = len(obj)
        if n != want:
            msg = f"{name}: {n} entries (reference documents {want})"
            if strict_counts:
                raise ValueError(msg)
            warnings.append(msg)
    with open(os.path.join(dst, "trainval_ans2label.json")) as f:
        a2l = json.load(f)
    with open(os.path.join(dst, "trainval_label2ans.json")) as f:
        l2a = json.load(f)
    if len(a2l) != len(l2a):
        raise ValueError("answer maps disagree in size")
    for ans, label in a2l.items():
        if not (0 <= label < len(l2a)) or l2a[label] != ans:
            raise ValueError(
                f"answer maps are not a bijection at {ans!r} -> {label}")
    return warnings


def copy_meta_assets(src: str, dst: str) -> list:
    """Copy the eight assets from the local directory ``src`` to ``dst``
    and validate them there."""
    os.makedirs(dst, exist_ok=True)
    for name, _, _ in META_ASSETS:
        path = os.path.join(src, name)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} not found: point --meta_src at a directory holding "
                f"the eight meta-info assets (e.g. an upstream checkout's "
                f"ISubGVQA/meta_info)")
        shutil.copyfile(path, os.path.join(dst, name))
    return validate_meta_assets(dst)


def mask_overlap(ours: dict, ref_masks, threshold: float = 0.5) -> dict:
    """Per-question agreement of the discrete subgraph with a recorded
    reference run: IoU of the thresholded node masks and the exact-set
    match rate, averaged over the qids both runs saw.  Masks of different
    lengths are padded with False, never truncated (a truncated tail could
    hide active reference nodes)."""
    import numpy as np

    ious, exact, size_mismatch = [], [], 0
    for qid, rec in ours.items():
        if qid not in ref_masks:
            continue
        a = np.asarray(rec["mask"]).reshape(-1) > threshold
        b = np.asarray(ref_masks[qid]).reshape(-1) > threshold
        if a.size != b.size:
            size_mismatch += 1
            m = max(a.size, b.size)
            a, b = np.pad(a, (0, m - a.size)), np.pad(b, (0, m - b.size))
        union = np.logical_or(a, b).sum()
        ious.append(float(np.logical_and(a, b).sum() / union)
                    if union else 1.0)
        exact.append(float(np.array_equal(a, b)))
    if not ious:
        return {"mask_iou": float("nan"), "mask_exact": float("nan"),
                "mask_n": 0, "mask_size_mismatch": 0}
    return {"mask_iou": float(np.mean(ious)),
            "mask_exact": float(np.mean(exact)), "mask_n": len(ious),
            "mask_size_mismatch": size_mismatch}


def write_report(out: str, payload: dict) -> None:
    """``<out>.json`` (the payload) and ``<out>.md`` (its metric table)."""
    with open(out + ".json", "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    lines = [
        "# Parity report",
        "",
        f"Checkpoint: `{payload['torch_ckpt']}`  ",
        f"Split: {payload['split']}  ·  samples: {payload['num_samples']}"
        f"  ·  sampler: {payload['sampler_type']}"
        f"  ·  mgat_masks: {payload['mgat_masks']}",
        "",
        "| metric | this framework | reference | delta |",
        "|---|---|---|---|",
    ]
    ref = payload.get("reference") or {}
    for k in METRIC_KEYS + ("mask_iou", "mask_exact"):
        if k not in payload["metrics"]:
            continue
        v, r = payload["metrics"][k], ref.get(k)
        d = (v - r) if (r is not None and v == v and r == r) else None
        lines.append(f"| {k} | {v:.4f} | "
                     f"{'-' if r is None else format(r, '.4f')} | "
                     f"{'-' if d is None else format(d, '+.4f')} |")
    if payload.get("notes"):
        lines += [""] + [f"> {n}" for n in payload["notes"]]
    lines.append("")
    with open(out + ".md", "w") as f:
        f.write("\n".join(lines))


def parse_overrides(pairs) -> dict:
    """``KEY=JSONVAL`` strings -> config overrides (a value that is not
    JSON stays a string; a list becomes a tuple)."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        out[k] = tuple(v) if isinstance(v, list) else v
    return out


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("parity_report (PyTorch)")
    p.add_argument("--torch_ckpt", required=True,
                   help="upstream .pth training checkpoint")
    p.add_argument("--data_dir", default=None, help="real GQA root")
    p.add_argument("--meta_dir", default=None,
                   help="directory already holding the 8 meta assets")
    p.add_argument("--meta_src", default=None,
                   help="local directory to copy and validate the meta "
                        "assets from first (e.g. an upstream "
                        "ISubGVQA/meta_info checkout)")
    p.add_argument("--clip_tokenizer_dir", default=None,
                   help="CLIP vocab.json/merges.txt (needed for real GQA: "
                        "the hash tokenizer's ids are not CLIP's)")
    p.add_argument("--split", default="dev", choices=["dev", "testdev"])
    p.add_argument("--synthetic", action="store_true",
                   help="run on the synthetic fixture")
    p.add_argument("--synthetic_size", type=int, default=None)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--reference_json", default=None,
                   help="recorded reference-run metrics to diff against "
                        "(keys among: accuracy accuracy_at ans_token_coo "
                        "qst_token_coo text_token_coo)")
    p.add_argument("--reference_masks", default=None,
                   help="npz of qid -> reference node mask for "
                        "subgraph-overlap parity")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=JSONVAL", dest="overrides",
                   help="Config field override, e.g. --set batch_size=8 "
                        "(JSON values; repeatable)")
    p.add_argument("--out", default="parity_report",
                   help="report path prefix (.json/.md appended)")
    p.add_argument("--work_dir", default="./parity_work",
                   help="the copied meta assets land here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    return p


def main(argv=None) -> dict:
    args = get_argparser().parse_args(argv)

    import numpy as np
    import torch

    from .convert import config_from_reference_args, load_upstream_state_dict
    from .data.build import build_datasets
    from .explain import run_token_coo_exp
    from .models.build import build_model, make_aimle_states, resolve_device

    device = resolve_device(args.device)

    # 1. the meta assets
    meta_dir = args.meta_dir
    if args.meta_src:
        meta_dir = os.path.join(args.work_dir, "meta_info")
        for w in copy_meta_assets(args.meta_src, meta_dir):
            print(f"meta-asset warning: {w}", file=sys.stderr)
    elif meta_dir and not args.synthetic:
        for w in validate_meta_assets(meta_dir):
            print(f"meta-asset warning: {w}", file=sys.stderr)

    # 2. the checkpoint and its config
    blob = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    cfg = config_from_reference_args(blob.get("args"))
    overrides = {}
    if meta_dir:
        overrides["meta_dir"] = meta_dir
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    if args.clip_tokenizer_dir:
        overrides["clip_tokenizer_dir"] = args.clip_tokenizer_dir
    if args.synthetic:
        overrides["synthetic"] = True
        if args.synthetic_size:
            overrides["synthetic_size"] = args.synthetic_size
    overrides.update(parse_overrides(args.overrides))
    cfg = dataclasses.replace(cfg, **overrides)
    sd = load_upstream_state_dict(blob, cfg.node_classification)
    print(f"loaded {args.torch_ckpt} (epoch {blob.get('epoch', -1)})")

    # 3. the eval and the explanation metrics
    data = build_datasets(cfg, pin_memory=device.type == "cuda")
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
    model = build_model(cfg, data.vocab, device, state_dict=sd)
    collected: dict = {}
    res = run_token_coo_exp(
        model=model, data=data, cfg=cfg, split=args.split,
        max_batches=args.max_batches, collect_masks=collected,
        aimle_states=make_aimle_states(cfg, device))

    # 4. the comparison
    metrics = {k: getattr(res, k) for k in METRIC_KEYS}
    notes = []
    if cfg.sampler_type and any(m != 1.0 for m in cfg.mgat_masks):
        notes.append(
            "masked configuration: the reference samples its eval masks "
            "WITH noise (reference quirk, see sampling/gumbel.py), so "
            "mask overlap and coo metrics carry sampler-seed variance "
            "on both sides; answer accuracy of unmasked layers is "
            "deterministic.")
    if args.reference_masks:
        metrics.update(mask_overlap(collected,
                                    dict(np.load(args.reference_masks))))
    reference = None
    if args.reference_json:
        with open(args.reference_json) as f:
            reference = json.load(f)

    payload = {
        "torch_ckpt": args.torch_ckpt,
        "checkpoint": os.path.abspath(args.torch_ckpt),
        "split": args.split,
        "synthetic": bool(args.synthetic),
        "num_samples": res.num_samples,
        "sampler_type": cfg.sampler_type,
        "mgat_masks": list(cfg.mgat_masks),
        "metrics": metrics,
        "reference": reference,
        "delta": {k: metrics[k] - reference[k]
                  for k in (reference or {})
                  if k in metrics and metrics[k] == metrics[k]},
        "notes": notes,
    }
    write_report(args.out, payload)
    print(f"report -> {args.out}.json / {args.out}.md")
    return payload


if __name__ == "__main__":
    main()
