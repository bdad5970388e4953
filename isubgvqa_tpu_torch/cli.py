"""Command-line training entry of the port (the port of
``isubgvqa_tpu/cli.py``; the reference's ``main.py:183-194`` and
``utils/arg_parser.py:4-137``)::

    python -m isubgvqa_tpu_torch.cli --synthetic --epochs 2 [--device cpu]

The same flags and defaults map onto :class:`~isubgvqa_tpu_torch.config.Config`,
the reference's flags that it ignores included; ``--scale_factor``
scales batch and lr; a resume adopts the checkpoint's config up front
and ``-e`` restores the model only.  Only ``--device`` differs: it
defaults to the card, and ``cpu`` runs the plain PyTorch path.  Every
model variant runs (``--text_sampling``, ``--use_all_instrs``,
``--concat_instr``, ``--use_global_mask``, ``--interpretable_mode``,
``--node_classification``, ``--use_instruction 0``, ``--use_topk 0``).
The port runs one process: ``--model_parallel`` and ``--num_data_shards``
above 1 raise (ROADMAP item 13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import pathlib

from .config import Config


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("ISubGVQA-TPU", add_help=False)
    d = Config()
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--mgat_layers", default=d.mgat_layers, type=int)
    p.add_argument("--log-name", default=d.log_name, type=str)
    p.add_argument("--epochs", default=d.epochs, type=int)
    p.add_argument("--start-epoch", default=d.start_epoch, type=int)
    p.add_argument("--nb_samples", default=d.nb_samples, type=int)
    p.add_argument("--alpha", default=d.alpha, type=float)
    p.add_argument("--beta", default=d.beta, type=float)
    p.add_argument("--tau", default=d.tau, type=float)
    p.add_argument("--batch-size", default=d.batch_size, type=int)
    p.add_argument("--lr", "--learning-rate", default=d.lr, type=float,
                   dest="lr")
    p.add_argument("--scale_factor", default=d.scale_factor, type=int)
    p.add_argument("-p", "--print-freq", default=d.print_freq, type=int)
    p.add_argument("--resume", default="", type=str)
    p.add_argument("-e", "--evaluate", action="store_true")
    p.add_argument("--pre_eval", action="store_true")
    p.add_argument("--seed", default=d.seed, type=int)
    p.add_argument("--output_dir", default=d.output_dir)
    p.add_argument("--use_instruction", type=int, default=1)
    p.add_argument("--use_masking", type=int, default=1)
    p.add_argument("--mgat_masks", nargs="+", type=float,
                   default=list(d.mgat_masks))
    p.add_argument("--use_topk", type=int, default=1)
    p.add_argument("--interpretable_mode", type=int, default=0)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--concat_instr", type=int, default=0)
    p.add_argument("--general_hidden_dim", type=int,
                   default=d.general_hidden_dim)
    p.add_argument("--use_all_instrs", action="store_true")
    p.add_argument("--use_global_mask", action="store_true")
    p.add_argument("--text_sampling", action="store_true")
    p.add_argument("--sampler_type", type=str, default=None)
    p.add_argument("--sample_k", type=int, default=None)
    p.add_argument("--node_classification", action="store_true")
    # flags the reference parses but never uses in its live path
    # (arg_parser.py:33-46,91,94,103-106,110,118-135): accepted and
    # ignored, as the reference and the JAX package ignore them
    p.add_argument("--lr_drop", default=30, type=int)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", "--weight-decay", default=1e-4, type=float,
                   dest="weight_decay")
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--evaluate_sets", default=["val_unbiased", "testdev"],
                   nargs="+")
    p.add_argument("--work_dir", default="./outputdir")
    p.add_argument("--gnn_gating", type=int, default=1)
    p.add_argument("--use_mgat", type=int, default=0)
    p.add_argument("--embed_cat", type=int, default=0)
    p.add_argument("--use_subgat", action="store_true")
    p.add_argument("--bi_qa", action="store_true")
    p.add_argument("--mask_regularization", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="no-op: the port runs one process")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    p.add_argument("--launcher", choices=["none", "pytorch", "slurm", "mpi"],
                   default="none")
    p.add_argument("--gpus", type=int, default=None)
    p.add_argument("--gpu-ids", type=int, nargs="+", default=None)
    # data and execution
    p.add_argument("--data_dir", default=d.data_dir)
    p.add_argument("--meta_dir", default=d.meta_dir)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=d.synthetic_size)
    p.add_argument("--synthetic_shape_mix", type=str,
                   default=d.synthetic_shape_mix, choices=["small", "gqa"])
    p.add_argument("--compute_dtype", default=d.compute_dtype)
    p.add_argument("--num_data_shards", type=int, default=None,
                   help="data-parallel ranks (the port runs one; ROADMAP "
                        "item 13)")
    p.add_argument("--model_parallel", type=int, default=d.model_parallel,
                   help="tensor-parallel ranks (the port runs one; ROADMAP "
                        "item 13)")
    p.add_argument("--question_len", type=int, default=d.question_len)
    p.add_argument("--clip_weights", default=d.clip_weights,
                   help="pretrained CLIP text token/position tables "
                        "(.npz/.safetensors/.pth) copied into the "
                        "question encoder at init, mirroring the "
                        "reference's CLIPModel deep-copy "
                        "(isubgvqa.py:119-121)")
    p.add_argument("--num_answers", type=int, default=d.num_answers)
    p.add_argument("--profile_dir", default=d.profile_dir,
                   help="trace fit() with torch.profiler here and log "
                        "per-epoch step-time summaries")
    p.add_argument("--multistep", type=int, default=d.multistep,
                   help="train steps per group of same-shape batches "
                        "(the JAX package's batch order under its "
                        "multistep; the steps run one after another)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    base = Config()
    if args.config and os.path.isfile(args.config):
        with open(args.config) as f:
            base = Config.from_json(f.read())
    fields = {f.name for f in dataclasses.fields(Config)}
    overrides = {k: v for k, v in vars(args).items()
                 if k in fields and v is not None}
    for flag in ("use_instruction", "use_masking", "use_topk",
                 "interpretable_mode", "concat_instr"):
        if flag in overrides:
            overrides[flag] = bool(overrides[flag])
    if "mgat_masks" in overrides:
        overrides["mgat_masks"] = tuple(overrides["mgat_masks"])
    if "start_epoch" not in overrides and hasattr(args, "start_epoch"):
        overrides["start_epoch"] = args.start_epoch
    return dataclasses.replace(base, **overrides)


def check_cli_supported(cfg: Config) -> None:
    """Raise on what the port does not run yet: more than one process
    (ROADMAP item 13)."""
    if cfg.model_parallel > 1 or (cfg.num_data_shards or 1) > 1:
        raise NotImplementedError(
            f"model_parallel={cfg.model_parallel}, num_data_shards="
            f"{cfg.num_data_shards}: the port runs one process (ROADMAP.md, "
            f"Queue 1 item 13: DDP)")


def main(argv=None):
    """Train (or with ``-e`` validate) as the JAX package's ``main`` does;
    returns the :class:`~isubgvqa_tpu_torch.train.Trainer`."""
    parser = argparse.ArgumentParser(
        "Intrinsic Subgraph Generation for Graph based VQA (PyTorch)",
        parents=[get_argparser()])
    args = parser.parse_args(argv)
    cfg = config_from_args(args).scaled()     # main.py:54-55
    check_cli_supported(cfg)

    import torch

    from .data.build import build_datasets
    from .models.build import resolve_device
    from .train.loop import Trainer

    device = resolve_device(args.device)
    if cfg.output_dir:
        pathlib.Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
        logging.basicConfig(                  # main.py:60-66
            filename=os.path.join(cfg.output_dir, cfg.log_name),
            filemode="w",
            format="%(asctime)s: %(levelname)s: [%(filename)s:%(lineno)d]: %(message)s",
            level=logging.INFO,
        )
        logging.info(str(cfg))

    print(f"torch version: {torch.__version__}")
    print(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                 if device.type == "cuda" else ""))
    print(f"scaled batch size of {cfg.batch_size}")
    print(f"scaled learning rate of {cfg.lr}")

    # the reference replaces args wholesale from the checkpoint on
    # resume (main.py:128-137): adopt the checkpointed config up front
    # so the rebuilt model and data match the restored state
    if cfg.resume:
        resume_path = cfg.resume if os.path.exists(cfg.resume) else \
            os.path.join(cfg.output_dir, cfg.resume)
        meta_path = resume_path + ".meta.json"
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                ckpt_cfg = Config.from_json(json.dumps(json.load(f)["config"]))
            cfg = dataclasses.replace(
                ckpt_cfg, resume=resume_path, evaluate=cfg.evaluate,
                pre_eval=cfg.pre_eval, output_dir=cfg.output_dir,
                epochs=cfg.epochs)

    data = build_datasets(cfg)
    # the classifier's width is the answer map's (1842 with the GQA
    # meta assets; isubgvqa.py:207)
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))

    trainer = Trainer(cfg, data, device=device)
    n_params = sum(p.numel() for p in trainer.state.model.parameters())
    print("number of params:", n_params)

    if cfg.resume:
        if os.path.exists(os.path.join(cfg.output_dir, cfg.resume)) or \
                os.path.exists(cfg.resume):
            start_epoch, _ = trainer.resume(
                cfg.resume, model_only=cfg.evaluate)   # main.py:131
            if not cfg.evaluate:
                cfg = dataclasses.replace(cfg, start_epoch=start_epoch)
                trainer.cfg = cfg
            print(f"=> loaded checkpoint '{cfg.resume}' (epoch {start_epoch - 1})")
            if not cfg.evaluate:
                opt = trainer.state.optimizer
                print(f"=> step {trainer.state.step}, optimizer count "
                      f"{opt.count}, learning rate {opt.lr()!r}")
        else:
            print(f"=> no checkpoint found at '{cfg.resume}'")

    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
