"""Multi-epoch convergence runs of the port for the four discrete
samplers (the port of ``scripts/train_convergence.py``).

For each sampler in {gumbel, simple, imle, aimle} this trains the masked
(1, 1, 1, 0.15) config of record (Adam lr 5e-5, batch 256, 10-epoch
warmup, ExponentialLR 0.98, k = 3) on the GQA-like synthetic task and
records per-epoch train loss, validation loss and accuracy, and the
final subgraph-mask statistics into one JSON artifact, in the schema of
the JAX package's ``TRAINRUN_r05.json``.  The file is rewritten after
every sampler.

    python -m isubgvqa_tpu_torch.train_convergence --epochs 80 \
        --out TRAINRUN_torch_h100.json [--samplers gumbel simple] [--resume]
    python -m isubgvqa_tpu_torch.train_convergence --device cpu \
        --config tiny.json --synthetic_size 64 --batch-size 16 --epochs 2

It runs on the card unless ``--device cpu`` is given.  ``--config``
(optional) is a JSON config whose fields the run's own settings
override: narrow widths for a run on the CPU.  ``--multistep K``
(default 8) trains as the port's Trainer does: K same-shape batches a
group, one CUDA graph replay a group on the card, on the trajectory of
ungrouped steps.  ``--resume``
continues each sampler from its rolling ``checkpoint``, when present:
the record then covers only the continued epochs, and the best accuracy
and lowest loss restart, as on the reference's resume
(``merge_trainruns`` joins the two records).

The synthetic task (``data/synthetic.py``) takes the asked object's
name as the answer where the name is in the answer map: with the GQA
meta-info assets, or the GQA-like stand-in that is written where they
are absent (``data/meta_fixture.py``), about 80 % of the answers are
recoverable from the question and graph, while the majority answer is
under 1 % and chance is 1 / 1842, so validation accuracy in the tens of
percent is evidence of learning.  The record's ``task`` holds these
shares as measured on the run's data.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from .config import Config

SAMPLERS = ("gumbel", "simple", "imle", "aimle")
MASKS = (1.0, 1.0, 1.0, 0.15)


def mask_statistics(trainer, data, cfg: Config, max_batches: int = 4) -> dict:
    """Final subgraph-mask statistics over the dev split.

    Reports, over valid nodes only: mean active-node count per graph,
    the exactly-k rate (k clamps to the graph's node count, matching
    per-graph top-k semantics), mean mask value, the share of pooling
    attention captured by the selected subgraph, and the mean count of
    active padding slots (the reference's zero-filled padding scores
    compete in top-k; a trained gate pushes real-node scores above them).
    Batch ``b``'s noise comes from a generator seeded from ``cfg.seed +
    999`` and ``b``."""
    from .data.batching import iterate_batches
    from .serve import batch_seed
    from .train.steps import make_eval_step

    eval_out = make_eval_step(trainer.state.model, cfg, return_output=True)
    ds = data.datasets["dev"]
    k = cfg.sample_k or 0
    active_counts, exact_k, mask_means, gate_shares = [], [], [], []
    pad_active_counts = []
    for b_idx, (batch, meta) in enumerate(
            iterate_batches(ds, data.collators["dev"])):
        if b_idx >= max_batches:
            break
        batch = batch.to(trainer.device)
        gen = torch.Generator(device=trainer.device).manual_seed(
            batch_seed(cfg.seed + 999, b_idx))
        _, out = eval_out(trainer.state, batch, gen)
        if out.node_mask is None:
            return {}
        mask = out.node_mask[..., 0].float().cpu().numpy()        # [B, N]
        gate = (out.gate[..., 0].float().cpu().numpy()
                if out.gate is not None else None)                # [B, N]
        valid = batch.node_mask.cpu().numpy().astype(bool)        # [B, N]
        real = batch.sample_mask.cpu().numpy() > 0
        for s in range(mask.shape[0]):
            if not real[s]:
                continue
            v = valid[s]
            m = mask[s][v]
            n_valid = int(v.sum())
            active = m > 0.5
            n_active = int(active.sum())
            active_counts.append(n_active)
            pad_active_counts.append(int((mask[s][~v] > 0.5).sum()))
            exact_k.append(float(n_active == min(k, n_valid)))
            mask_means.append(float(m.mean()) if n_valid else 0.0)
            if gate is not None and n_active and n_active < n_valid:
                g = gate[s][v]
                gate_shares.append(float(g[active].sum() / max(g.sum(), 1e-9)))
    return {
        "mean_active_nodes": round(float(np.mean(active_counts)), 3),
        "mean_active_padding": round(float(np.mean(pad_active_counts)), 3),
        "exactly_k_rate": round(float(np.mean(exact_k)), 4),
        "mean_mask_value": round(float(np.mean(mask_means)), 4),
        "selected_gate_share": (round(float(np.mean(gate_shares)), 4)
                                if gate_shares else None),
        "k": k,
        "n_graphs": len(active_counts),
    }


def run_config(sampler: str, args) -> Config:
    """The config of one sampler's run: ``args.config``'s JSON (or the
    defaults) under the config of record, one node bucket at
    ``args.node_cap`` and one question length.  Where the config names no
    meta-info assets (``meta_dir``, by default ``$ISUBGVQA_META_DIR``), a
    GQA-like stand-in is written under ``args.output_root``
    (:mod:`.data.meta_fixture`): with the synthetic vocabulary no object
    name is an answer, every answer is random and nothing could be
    learned."""
    base = Config()
    if getattr(args, "config", None):
        with open(args.config) as f:
            base = Config.from_json(f.read())
    meta_dir = base.meta_dir
    if not meta_dir:
        from .data.meta_fixture import write_gqa_like_meta

        meta_dir = write_gqa_like_meta(
            os.path.join(args.output_root, "meta_info"))
    return dataclasses.replace(
        base, sampler_type=sampler, sample_k=args.sample_k,
        mgat_masks=MASKS, use_topk=True,
        synthetic=True, synthetic_size=args.synthetic_size,
        synthetic_shape_mix=args.shape_mix,
        batch_size=args.batch_size, epochs=args.epochs,
        question_len=args.question_len,
        # one size bucket: one shape to train and validate at
        bucket_node_caps=(args.node_cap,),
        bucket_question_lens=(args.question_len,),
        max_nodes_per_graph=args.node_cap,
        multistep=args.multistep, meta_dir=meta_dir,
        output_dir=os.path.join(args.output_root, sampler),
        print_freq=1000)


def run_sampler(sampler: str, args, device=None) -> dict:
    """Train one sampler for ``args.epochs`` epochs (from its rolling
    checkpoint with ``args.resume``) and return its record: the epoch
    rows, best validation accuracy, lowest validation loss, final mask
    statistics, wall seconds and parameter count."""
    from .data.build import build_datasets
    from .models.build import resolve_device
    from .train.loop import Trainer

    device = resolve_device(device if device is not None
                            else getattr(args, "device", None))
    cfg = run_config(sampler, args)
    os.makedirs(cfg.output_dir, exist_ok=True)
    data = build_datasets(cfg, pin_memory=device.type == "cuda")
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
    trainer = Trainer(cfg, data, device=device)

    start_epoch = 0
    rolling = os.path.join(cfg.output_dir, "checkpoint")
    if args.resume and os.path.isfile(rolling):
        start_epoch, _ = trainer.resume(rolling)
        print(f"[{sampler}] resumed epoch {start_epoch}", flush=True)

    t0 = time.time()
    epochs = []
    top_acc, lowest_loss = 0.0, float("inf")
    opt = trainer.state.optimizer
    for epoch in range(start_epoch, cfg.epochs):
        te0 = time.time()
        steps, count = trainer.state.step, int(opt.count)
        train_loss = trainer.train_epoch(epoch)
        val_acc, val_loss = trainer.validate_epoch(epoch)
        lowest_loss, top_acc = trainer.ckpt.save_policy(
            trainer.state, epoch, cfg, val_loss, val_acc,
            lowest_loss, top_acc)
        rec = {"epoch": epoch, "train_loss": round(float(train_loss), 4),
               "val_loss": round(float(val_loss), 4),
               "val_acc": round(float(val_acc), 3),
               "epoch_s": round(time.time() - te0, 1),
               # steps whose gradients held a non-finite value: the
               # optimizer skips them and the loss meter leaves them out
               "skipped_steps": (trainer.state.step - steps)
               - (int(opt.count) - count)}
        epochs.append(rec)
        print(f"[{sampler}] {rec}", flush=True)
    stats = mask_statistics(trainer, data, cfg)
    return {
        "sampler": sampler,
        "epochs": epochs,
        "best_val_acc": round(float(top_acc), 3),
        "lowest_val_loss": round(float(lowest_loss), 4),
        "final_mask_stats": stats,
        "wall_s": round(time.time() - t0, 1),
        "params": int(sum(p.numel()
                          for p in trainer.state.model.parameters())),
    }


def describe_device(device) -> str:
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def task_statistics(cfg: Config) -> dict:
    """The synthetic task's answer statistics, measured: the share of
    training questions whose answer is the name of an object of their
    graph (recoverable), the majority answer's share of the validation
    questions, and chance, in %."""
    from .data import AnswerMap, SceneGraphVocab, SyntheticGQA

    vocab = SceneGraphVocab.build(cfg.meta_dir, seed=cfg.seed)
    answers = AnswerMap.build(cfg.meta_dir, cfg.num_answers)
    split = {}
    for name, size in (("train", cfg.synthetic_size),
                       ("valid", max(cfg.synthetic_size // 4, 1))):
        split[name] = SyntheticGQA(vocab, answers, size=size, seed=cfg.seed,
                                   split=name,
                                   shape_mix=cfg.synthetic_shape_mix)
    ds = split["train"]
    named = np.mean([ans in {o["name"] for o in
                             ds.store.scene_graphs[img]["objects"].values()}
                     for _, img, _, ans in ds.samples])
    _, top = np.unique([s[3] for s in split["valid"].samples],
                       return_counts=True)
    return {"num_answers": len(answers),
            "answer_in_question_frac": round(float(named), 4),
            "majority_baseline_acc_pct": round(
                100.0 * float(top.max()) / len(split["valid"]), 4),
            "chance_acc_pct": round(100.0 / len(answers), 4)}


def new_record(args, device, cfg: Config) -> dict:
    """The artifact's header (everything but ``runs``)."""
    from .data import meta_fixture

    if os.path.abspath(cfg.meta_dir) == os.path.abspath(
            os.path.join(args.output_root, "meta_info")):
        meta = ("GQA-like meta_info stand-in "
                f"(isubgvqa_tpu_torch/data/meta_fixture.py, seed "
                f"{meta_fixture.SEED})")
    else:
        meta = f"GQA meta_info at {cfg.meta_dir}"
    return {
        "purpose": ("multi-epoch convergence evidence of the PyTorch port "
                    "for the four discrete samplers; reference equivalent: "
                    "training/train_loop.py:72-110 validation loop on the "
                    "configs of record (run_training.sh:5-13)"),
        "backend": torch.device(device).type,
        "device": describe_device(device),
        "task": {
            "dataset": f"synthetic mini-GQA (shape_mix={args.shape_mix})",
            "meta": meta,
            "train_size": args.synthetic_size,
            "val_size": max(args.synthetic_size // 4, 1),
            **task_statistics(cfg),
        },
        "config": {"batch_size": args.batch_size, "lr": 5e-5,
                   "epochs": args.epochs, "sample_k": args.sample_k,
                   "mgat_masks": list(MASKS),
                   "warmup_epochs": 10, "lr_gamma": 0.98,
                   "multistep": args.multistep,
                   "question_len": args.question_len,
                   "node_cap": args.node_cap,
                   "seed": cfg.seed},
        "runs": {},
    }


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "python -m isubgvqa_tpu_torch.train_convergence")
    p.add_argument("--samplers", nargs="+", default=list(SAMPLERS),
                   choices=SAMPLERS)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--synthetic_size", type=int, default=8192)
    p.add_argument("--shape_mix", default="gqa", choices=["small", "gqa"])
    p.add_argument("--batch-size", type=int, default=256, dest="batch_size")
    p.add_argument("--sample_k", type=int, default=3)
    p.add_argument("--question_len", type=int, default=32)
    p.add_argument("--node_cap", type=int, default=128)
    p.add_argument("--multistep", type=int, default=8)
    p.add_argument("--output_root", default="outputdir/trainrun_torch")
    p.add_argument("--out", default="TRAINRUN_torch.json")
    p.add_argument("--config", default=None,
                   help="JSON config whose fields the run's settings "
                        "override (narrow widths for the CPU; its meta_dir "
                        "names the GQA meta-info assets)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    p.add_argument("--resume", action="store_true",
                   help="continue from each sampler's rolling checkpoint "
                        "when present (per-epoch records then cover only "
                        "the continued epochs)")
    return p


def main(argv=None) -> dict:
    from .models.build import resolve_device

    args = get_argparser().parse_args(argv)
    device = resolve_device(args.device)
    result = new_record(args, device, run_config(args.samplers[0], args))
    for sampler in args.samplers:
        print(f"=== {sampler} ===", flush=True)
        result["runs"][sampler] = run_sampler(sampler, args, device)
        with open(args.out, "w") as f:        # progress after every run
            json.dump(result, f, indent=1)
    print(json.dumps({s: {"best_val_acc": r["best_val_acc"],
                          "mask": r["final_mask_stats"]}
                      for s, r in result["runs"].items()}, indent=1))
    return result


if __name__ == "__main__":
    main()
