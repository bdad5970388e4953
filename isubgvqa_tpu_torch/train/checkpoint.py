"""Checkpoints with the reference's three-checkpoint policy (the port of
``isubgvqa_tpu/train/checkpoint.py``; the reference's
``training/train_loop.py:84-130`` and ``main.py:124-139``):

* ``checkpoint`` every epoch, and ``checkpoint{epoch:04d}`` every 50;
* ``checkpoint_lowest_val_loss`` on a new lowest validation loss;
* ``checkpoint_top_res`` on a new best validation accuracy.

Each is one ``torch.save`` file at ``<output_dir>/<name>`` beside the
JAX package's ``<name>.meta.json`` (``{"epoch", "config"}``), which
either package's ``Config.from_json`` reads.  The payload holds plain
tensors, dicts, numbers and strings only, so ``torch.load(...,
weights_only=True)`` opens it:

* ``config`` (JSON) and ``state_dict``, the model's weights and
  BatchNorm buffers in f32: the two keys that
  :meth:`~isubgvqa_tpu_torch.serve.Predictor.from_checkpoint` reads;
* ``optimizer`` (Adam's state), ``count`` and ``notfinite_count``;
* ``step`` (the train state's step), ``aimle_states`` (each masked
  layer's three 0-d tensors, or ``None``) and ``epoch``.

A payload exported from the JAX package
(``convert.train_payload_from_jax``) is built by :func:`state_payload`
too and written by :func:`write_checkpoint`; one exported from weights
alone lacks the optimizer's four keys, and a training resume refuses
it.

A file is written under a temporary name and renamed over the old one
(``os.replace``), so a run killed while writing never leaves a
half-written checkpoint.  In a data-parallel run only rank 0 writes (the
JAX package's ``save_on_master``), every rank waits at a barrier after
each save, and every rank loads on resume.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from ..config import Config
from ..parallel.mesh import barrier, is_main_process
from ..sampling.aimle import AIMLE_FIELDS
from .state import TrainState

# the keys a training resume needs beyond the model's
TRAINING_KEYS = ("optimizer", "count", "notfinite_count", "step")


def state_payload(state: TrainState, epoch: int, cfg: Config) -> dict:
    """The checkpoint payload of ``state`` after ``epoch``, its tensors
    copied to the CPU."""
    adam = state.optimizer.adam.state_dict()
    adam["state"] = {i: {k: v.detach().cpu() for k, v in st.items()}
                     for i, st in adam["state"].items()}
    return {
        "config": cfg.to_json(),
        "state_dict": {k: v.detach().float().cpu()
                       for k, v in state.model.state_dict().items()},
        "optimizer": adam,
        "count": state.optimizer.count,
        "notfinite_count": state.optimizer.notfinite_count,
        "step": state.step,
        "aimle_states": (None if state.aimle_states is None else {
            str(i): {f: getattr(st, f).detach().cpu() for f in AIMLE_FIELDS}
            for i, st in state.aimle_states.items()}),
        "epoch": epoch,
    }


def write_checkpoint(payload: dict, path: str) -> None:
    """``payload`` (a :func:`state_payload`) to ``path`` beside
    ``<path>.meta.json`` (its epoch and config), each written under a
    temporary name and renamed over the old file."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    meta = {"epoch": payload["epoch"],
            "config": json.loads(payload["config"])}
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path + ".meta.json")


class CheckpointManager:
    def __init__(self, output_dir: str):
        self.output_dir = os.path.abspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(
            self.output_dir, name)

    def save(self, name: str, state: TrainState, epoch: int, cfg: Config,
             _payload: Optional[dict] = None):
        """Write ``name`` on rank 0; every rank then meets at a barrier."""
        if is_main_process():
            self._write(name, state, epoch, cfg, _payload)
        barrier()

    def _write(self, name: str, state: TrainState, epoch: int, cfg: Config,
               _payload: Optional[dict] = None):
        write_checkpoint(_payload if _payload is not None else
                         state_payload(state, epoch, cfg), self._path(name))

    def save_policy(self, state: TrainState, epoch: int, cfg: Config,
                    val_loss: float, val_acc: float,
                    best_loss: float, best_acc: float) -> Tuple[float, float]:
        """Apply the reference's checkpoint policy; returns the updated
        ``(best_loss, best_acc)``.  The state crosses to the host once per
        epoch, shared by every checkpoint written (on rank 0 only)."""
        payload = (state_payload(state, epoch, cfg) if is_main_process()
                   else None)
        if val_loss < best_loss:                      # train_loop.py:84-96
            best_loss = val_loss
            self.save("checkpoint_lowest_val_loss", state, epoch, cfg,
                      _payload=payload)
        if val_acc > best_acc:                        # train_loop.py:98-110
            best_acc = val_acc
            self.save("checkpoint_top_res", state, epoch, cfg,
                      _payload=payload)
        self.save("checkpoint", state, epoch, cfg,    # train_loop.py:115-130
                  _payload=payload)
        if (epoch + 1) % 50 == 0:
            self.save(f"checkpoint{epoch:04d}", state, epoch, cfg,
                      _payload=payload)
        return best_loss, best_acc

    def restore(self, name: str, state: TrainState, model_only: bool = False
                ) -> Tuple[int, Optional[Config]]:
        """Resume (``main.py:124-139``): load the checkpoint into ``state``
        in place; returns ``(next_start_epoch, checkpointed config)``.

        ``model_only`` loads the weights, the BatchNorm buffers and the
        AIMLE states but not the optimizer, the count or the step: the
        reference's eval-time resume (``main.py:131``)."""
        path = self._path(name)
        blob = torch.load(path, map_location="cpu", weights_only=True)
        missing = [k for k in TRAINING_KEYS if k not in blob]
        if missing and not model_only:
            raise ValueError(
                f"{path} holds the model only (no {', '.join(missing)}): it "
                f"can be validated (-e), served or explained, not resumed "
                f"for training")
        state.model.load_state_dict(blob["state_dict"], strict=True)
        if state.aimle_states is not None and blob.get("aimle_states"):
            with torch.no_grad():
                for i, st in state.aimle_states.items():
                    saved = blob["aimle_states"][str(i)]
                    for f in AIMLE_FIELDS:
                        getattr(st, f).copy_(saved[f])
        if not model_only:
            state.optimizer.adam.load_state_dict(blob["optimizer"])
            state.optimizer.count = int(blob["count"])
            state.optimizer.notfinite_count = int(blob["notfinite_count"])
            state.step = int(blob["step"])
        epoch, cfg = -1, None
        meta_path = path + ".meta.json"
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            epoch = meta.get("epoch", -1)
            cfg = Config.from_json(json.dumps(meta.get("config", {})))
        return epoch + 1, cfg
