"""Explanation-extraction entry of the port (the counterpart of the root
``run_token_coo.py``, the reference's ``run_token_coo.py``): loads a
Trainer checkpoint, runs a split through the eval forward with the node
masks returned, and prints accuracy, accuracy-AT and the
token-co-occurrence metrics::

    python -m isubgvqa_tpu_torch.run_token_coo \\
        --ckpt <output_dir>/checkpoint_top_res [--synthetic] \\
        [--save_expl --expl_dir ./expl] [--device cpu]

The model runs on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser("run_token_coo (PyTorch)")
    p.add_argument("--ckpt", required=True,
                   help="Trainer checkpoint (e.g. outputdir/checkpoint_top_res)")
    p.add_argument("--split", default="dev", choices=["dev", "testdev"])
    p.add_argument("--save_expl", action="store_true")
    p.add_argument("--save_qst_meta_data", action="store_true")
    p.add_argument("--expl_dir", default="./saved_explanations")
    p.add_argument("--expl_format", default="png", choices=["png", "pdf"],
                   help="rendered subgraph format (the reference saves PNG,"
                        " utils/graph_vis.py:60-66)")
    p.add_argument("--run", default="run")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from .config import Config
    from .data.build import build_datasets
    from .explain import run_token_coo_exp
    from .models.build import build_model, resolve_device
    from .train.checkpoint import CheckpointManager
    from .train.state import create_train_state

    device = resolve_device(args.device)
    meta_path = args.ckpt + ".meta.json"
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"checkpoint meta not found: {meta_path}")
    with open(meta_path) as f:
        meta = json.load(f)
    cfg = Config.from_json(json.dumps(meta["config"]))   # run_token_coo.py:29-45
    if args.synthetic:
        cfg = dataclasses.replace(cfg, synthetic=True)

    data = build_datasets(cfg, pin_memory=device.type == "cuda")
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
    state = create_train_state(cfg, data.vocab, steps_per_epoch=1,
                               device=device)
    ckpt_path = os.path.abspath(args.ckpt)
    CheckpointManager(os.path.dirname(ckpt_path)).restore(
        ckpt_path, state, model_only=True)
    # the eval model ships its weights at the compute dtype once
    model = build_model(cfg, data.vocab, device,
                        state_dict=state.model.state_dict())
    aimle_states = state.aimle_states
    del state

    return run_token_coo_exp(
        model=model, data=data, cfg=cfg, split=args.split,
        save_expl=args.save_expl, expl_dir=args.expl_dir, run=args.run,
        save_qst_meta_data=args.save_qst_meta_data,
        max_batches=args.max_batches, expl_format=args.expl_format,
        aimle_states=aimle_states)


if __name__ == "__main__":
    main()
