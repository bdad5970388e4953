"""One rank of the two-rank Gloo job of ``tests/test_torch_port_ddp.py``.

    python tests/torch_port_ddp_worker.py <workdir> <rank> <world>

Imports the port only (no JAX).  The rank joins the group through a
``FileStore`` under ``<workdir>`` and then:

1. trains ``<workdir>/trainer.json``'s config (aimle, dropouts on) with
   the :class:`Trainer` for one epoch (two steps a rank), validates and
   runs the checkpoint policy; it records each step's batch and metrics,
   the local validation sums handed to ``reduce_dict``, the checkpoints
   it wrote, what it printed, and the state after;
2. runs the collectives of ``train/distributed_metrics.py`` on known
   values;
3. takes one train step of ``<workdir>/step.pt`` (a gumbel config with
   no dropout, weights, the global batch and the global Gumbel draw) on
   its rows of the batch, and records the summed gradients and metrics.

Everything lands in ``<workdir>/rank<r>.pt``.
"""

import contextlib
import datetime
import io
import os
import sys

import torch


def _clone(batch):
    return {k: v.clone() for k, v in vars(batch).items()}


def _keep(rank, tensors):
    """Rank 0 keeps the tensors; another rank their per-leaf sums in f64
    (enough to tell that the ranks hold the same values)."""
    if rank == 0:
        return {k: v.detach().clone() for k, v in tensors.items()}
    return {k: float(v.detach().double().sum()) for k, v in tensors.items()}


def train_with_trainer(workdir, rank, record):
    from isubgvqa_tpu_torch.config import Config
    from isubgvqa_tpu_torch.data import build_datasets
    from isubgvqa_tpu_torch.train import checkpoint, loop
    from isubgvqa_tpu_torch.train.loop import Trainer

    with open(os.path.join(workdir, "trainer.json")) as f:
        cfg = Config.from_json(f.read())
    data = build_datasets(cfg)
    trainer = Trainer(cfg, data, device="cpu")
    for st in trainer.state.aimle_states.values():
        st.beta.fill_(5.0)              # the sampler's gradient is live
    record["init"] = _keep(rank, trainer.state.model.state_dict())
    opt = trainer.state.optimizer
    opt_step = opt.step

    def first_grads():
        if "grads0" not in record:
            record["grads0"] = _keep(rank, {
                n: p.grad for n, p in trainer.state.model.named_parameters()})
        return opt_step()

    opt.step = first_grads
    steps = record["steps"] = []
    step = trainer.train_step

    def recorded(state, batch):
        b = _clone(batch)
        state, m = step(state, batch)
        steps.append({"batch": b, "metrics": {
            k: float(v) for k, v in m.items()}})
        return state, m

    trainer.train_step = recorded
    reduce_dict = loop.reduce_dict

    def recorded_reduce(d, average=True):
        record["val_local"] = dict(d)
        return reduce_dict(d, average)

    loop.reduce_dict = recorded_reduce
    written = record["written"] = []
    write = checkpoint.CheckpointManager._write

    def recorded_write(self, name, *args, **kw):
        written.append(name)
        return write(self, name, *args, **kw)

    checkpoint.CheckpointManager._write = recorded_write
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer.fit()
    record["printed"] = out.getvalue()
    record["val_totals"] = trainer.val_totals
    st = trainer.state
    record["final"] = _keep(rank, st.model.state_dict())
    record["aimle"] = {i: [float(s.beta), float(s.grad_norm),
                           float(s.prev_update)]
                       for i, s in st.aimle_states.items()}
    record["count"] = st.optimizer.count


def collectives(rank, record):
    from isubgvqa_tpu_torch.train.distributed_metrics import (
        SmoothedValue, all_gather_objects, reduce_dict)

    record["reduce_avg"] = reduce_dict({"a": rank + 1.0, "b": 2.0})
    record["reduce_sum"] = reduce_dict({"a": rank + 1.0, "b": 2.0},
                                       average=False)
    record["gathered"] = all_gather_objects({"rank": rank,
                                             "ids": [rank] * (rank + 1)})
    meter = SmoothedValue()
    meter.update(float(rank + 1), n=rank + 2)
    meter.synchronize_between_processes()
    record["meter"] = (meter.count, meter.total)


def one_step(workdir, rank, world, record):
    from isubgvqa_tpu_torch.config import Config
    from isubgvqa_tpu_torch.data import GraphBatch, SceneGraphVocab
    from isubgvqa_tpu_torch.sampling import gumbel
    from isubgvqa_tpu_torch.train import create_train_state, make_train_step

    blob = torch.load(os.path.join(workdir, "step.pt"), weights_only=False)
    cfg = Config.from_json(blob["config"])
    noise = blob["noise"]
    gumbel.draw_gumbel = (lambda shape, generator, device:
                          noise.reshape(shape))
    b = blob["batch"]["labels"].shape[0] // world
    batch = GraphBatch(**{k: v[rank * b:(rank + 1) * b].clone()
                          for k, v in blob["batch"].items()})
    st = create_train_state(cfg, SceneGraphVocab.synthetic(),
                            blob["steps_per_epoch"], device="cpu",
                            state_dict=blob["state_dict"])
    opt_step = st.optimizer.step

    def recorded():
        record["step_grads"] = _keep(rank, {
            n: p.grad for n, p in st.model.named_parameters()})
        return opt_step()

    st.optimizer.step = recorded
    _, m = make_train_step(st.model, st.optimizer, cfg)(st, batch)
    record["step_metrics"] = {k: float(v) for k, v in m.items()}


def main():
    workdir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from isubgvqa_tpu_torch import parallel

    parallel.init_distributed(
        "cpu", timeout=datetime.timedelta(seconds=60),
        init_method="file://" + os.path.join(workdir, "store"))
    record = {"rank": parallel.rank(), "world": parallel.world_size()}
    try:
        train_with_trainer(workdir, rank, record)
        collectives(rank, record)
        one_step(workdir, rank, world, record)
        torch.save(record, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
