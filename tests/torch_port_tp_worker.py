"""One rank of the 2 x 2 tensor-parallel Gloo job of
``tests/test_torch_port_tp.py``.

    python tests/torch_port_tp_worker.py <workdir> <rank> <world>

Imports the port only (no JAX).  The rank joins the group through a
``FileStore`` under ``<workdir>``, splits it into 2 data ranks of 2 model
ranks (``init_mesh(2)``) and then:

1. for ``gumbel.pt`` and ``aimle.pt`` (a config with no dropout, weights,
   the global batch, the global Gumbel draw and the step count): cuts the
   two tables to its shard, takes the steps on its data rank's rows and
   records each step's metrics, the shapes it holds and, through the
   checkpoint's ``state_payload``, the gathered weights and Adam moments;
2. runs the two model-region functions forward and backward on known
   values;
3. trains ``cli.main --model_parallel 2`` for one epoch (rank 0 writes the
   checkpoint), then resumes that checkpoint into a fresh 2 x 2
   ``Trainer`` and records whether its shards and Adam moments equal the
   trained ones.

Everything lands in ``<workdir>/rank<r>.pt``.
"""

import contextlib
import datetime
import io
import os
import sys

import torch


def take_steps(workdir, name, rank, record):
    """The steps of ``<workdir>/<name>.pt`` under its shared draw."""
    from isubgvqa_tpu_torch.sampling import gumbel, noise as noise_mod

    blob = torch.load(os.path.join(workdir, f"{name}.pt"), weights_only=False)
    draw = blob["noise"]
    saved = gumbel.draw_gumbel
    gumbel.draw_gumbel = noise_mod.draw_gumbel = (
        lambda shape, generator, device: draw.reshape(shape))
    try:
        _steps(blob, name, rank, record)
    finally:
        gumbel.draw_gumbel = noise_mod.draw_gumbel = saved


def _steps(blob, name, rank, record):
    from isubgvqa_tpu_torch import parallel
    from isubgvqa_tpu_torch.config import Config
    from isubgvqa_tpu_torch.data import GraphBatch, SceneGraphVocab
    from isubgvqa_tpu_torch.train import create_train_state, make_train_step
    from isubgvqa_tpu_torch.train.checkpoint import state_payload

    cfg = Config.from_json(blob["config"])
    d, b = parallel.data_rank(), blob["batch"]["labels"].shape[0] // 2
    batch = GraphBatch(**{k: v[d * b:(d + 1) * b].clone()
                          for k, v in blob["batch"].items()})
    st = create_train_state(cfg, SceneGraphVocab.synthetic(),
                            blob["steps_per_epoch"], device="cpu",
                            state_dict=blob["state_dict"])
    if st.aimle_states is not None:
        for s in st.aimle_states.values():
            s.beta.fill_(blob["beta"])
    parallel.shard_model_(st.model)
    step = make_train_step(st.model, st.optimizer, cfg)
    metrics = []
    for _ in range(blob["n_steps"]):
        st, m = step(st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    payload = state_payload(st, 0, cfg)       # gathers over the model group
    names = [n for n, _ in st.model.named_parameters()]
    out = {"metrics": metrics, "shapes": {
        n: tuple(p.shape) for n, p in st.model.named_parameters()
        if parallel.shard_dim(p) is not None}}
    if rank == 0:
        out["state_dict"] = payload["state_dict"]
        out["adam"] = {names[i]: {k: v for k, v in s.items() if v.dim()}
                       for i, s in payload["optimizer"]["state"].items()}
        out["aimle"] = payload["aimle_states"]
    record[name] = out


def model_regions(record):
    from isubgvqa_tpu_torch import parallel

    m = parallel.model_rank()
    upstream = torch.arange(3.0) + 10.0 * m
    x = torch.full((3,), float(parallel.rank() + 1), requires_grad=True)
    y = parallel.reduce_from_model_region(x)
    y.backward(upstream)
    record["reduce"] = (y.detach(), x.grad.clone())
    x = torch.full((3,), float(parallel.rank() + 1), requires_grad=True)
    y = parallel.copy_to_model_region(x)
    y.backward(upstream)
    record["copy"] = (y.detach(), x.grad.clone())


def cli_epoch_and_resume(workdir, rank, record):
    from isubgvqa_tpu_torch import cli, parallel
    from isubgvqa_tpu_torch.data import build_datasets
    from isubgvqa_tpu_torch.train.loop import Trainer

    with open(os.path.join(workdir, "argv.txt")) as f:
        argv = f.read().split()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = cli.main(argv)
    record["printed"] = printed.getvalue()
    record["val_totals"] = trainer.val_totals
    record["count"] = trainer.state.optimizer.count
    ckpt = os.path.join(trainer.cfg.output_dir, "checkpoint")
    resumed = Trainer(trainer.cfg, build_datasets(trainer.cfg), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        resumed.resume(ckpt)
    a, b = trainer.state, resumed.state
    same = all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                  b.model.parameters()))
    moments = [(a.optimizer.adam.state[p], b.optimizer.adam.state[q])
               for p, q in zip(a.optimizer.params, b.optimizer.params)]
    same_adam = all(torch.equal(s[k], t[k]) for s, t in moments
                    for k in ("exp_avg", "exp_avg_sq"))
    record["resume"] = {
        "params": same, "adam": same_adam,
        "count": b.optimizer.count, "step": b.step,
        "sharded": sorted(n for n, p in b.model.named_parameters()
                          if parallel.shard_dim(p) is not None)}


def main():
    workdir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from isubgvqa_tpu_torch import parallel

    parallel.init_distributed(
        "cpu", timeout=datetime.timedelta(seconds=120),
        init_method="file://" + os.path.join(workdir, "store"))
    parallel.init_mesh(2)
    record = {"rank": rank, "data_rank": parallel.data_rank(),
              "model_rank": parallel.model_rank()}
    try:
        for name in ("gumbel", "aimle"):
            take_steps(workdir, name, rank, record)
        model_regions(record)
        cli_epoch_and_resume(workdir, rank, record)
        torch.save(record, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    main()
