"""Localize nonfinite values in the training forward and backward (the
port of ``scripts/nan_localizer.py``).

Loads a port checkpoint (e.g. a convergence run's rolling checkpoint)
with its ``.meta.json`` config, reports the health of each state group
(parameters, buffers, Adam's ``exp_avg`` / ``exp_avg_sq``, the AIMLE
state), then replays training batches of the checkpoint's epoch and the
next one (each with its shuffle seed, ``cfg.seed + epoch``) at the
checkpoint's weights until one gives a nonfinite loss or gradient norm.
That batch then runs again with forward hooks on every module, and the
first nonfinite outputs are printed in call order with each one's
nonfinite share.  A fused layer's output (the ``autograd.Function`` of a
kernel) counts as an output of the module that calls it, named with the
function and its call index there.  If every forward output is finite,
the NaN is backward-only.

    python -m isubgvqa_tpu_torch.nan_localizer \
        --ckpt outputdir/trainrun_torch/gumbel/checkpoint [--device cpu]

A replayed step updates nothing: the BatchNorm running statistics and the
AIMLE state that a training forward and backward write in place are put
back after each step, and the optimizer does not run.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
from typing import Callable, List, Optional, Tuple

import torch

from .config import Config
from .models.fused_sites import FUSED_SITES, site_module


def _tensors(obj):
    """Every tensor in ``obj`` (tensors, tuples, lists, dicts and
    dataclasses such as ``ModelOutput``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def nonfinite_share(obj) -> float:
    """The share of nonfinite elements over the floating tensors of
    ``obj`` (0 when there are none)."""
    bad = total = 0
    for t in _tensors(obj):
        if t.is_floating_point():
            bad += int((~torch.isfinite(t.detach())).sum())
            total += t.numel()
    return bad / total if total else 0.0


def health(state) -> List[Tuple[str, List[str]]]:
    """``[(group, names holding a nonfinite value)]`` for the parameters,
    buffers, Adam's two moments and the AIMLE state."""
    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    adam = state.optimizer.adam.state
    groups = [
        ("parameters", [(n, p) for n, p in model.named_parameters()]),
        ("buffers", [(n, b) for n, b in model.named_buffers()]),
    ]
    for key in ("exp_avg", "exp_avg_sq"):
        groups.append((key, [(names[id(p)], adam[p][key])
                             for p in state.optimizer.params
                             if p in adam and key in adam[p]]))
    groups.append(("aimle_states", [
        (f"{i}.{f.name}", getattr(st, f.name))
        for i, st in (state.aimle_states or {}).items()
        for f in dataclasses.fields(st)]))
    return [(g, [n for n, t in items if t.is_floating_point()
                 and not bool(torch.isfinite(t).all())])
            for g, items in groups]


@contextlib.contextmanager
def untouched(state):
    """Put back, on exit, the BatchNorm buffers and the AIMLE state that
    a training forward and backward update in place."""
    buffers = {n: b.clone() for n, b in state.model.named_buffers()}
    aimle = copy.deepcopy(state.aimle_states)
    try:
        yield
    finally:
        with torch.no_grad():
            for n, b in state.model.named_buffers():
                b.copy_(buffers[n])
            for i, st in (aimle or {}).items():
                for f in dataclasses.fields(st):
                    getattr(state.aimle_states[i], f.name).copy_(
                        getattr(st, f.name))


@contextlib.contextmanager
def record_outputs(model: torch.nn.Module, records: list):
    """Append ``(name, output)`` to ``records`` for every module output
    and every fused layer's output, in the order they are produced.  A
    fused layer is named after the module that calls it: ``<module>
    [<function> call <i>]``, ``i`` counting that module's calls of the
    function in this forward."""
    stack: List[str] = []
    calls: dict = {}
    names = {m: n or "model" for n, m in model.named_modules()}

    def pre(mod, args):
        stack.append(names[mod])

    def post(mod, args, out):
        stack.pop()
        records.append((names[mod], out))

    def wrap(fn: Callable, fname: str):
        def fused(*args, **kw):
            out = fn(*args, **kw)
            owner = stack[-1] if stack else "model"
            i = calls.get((owner, fname), 0)
            calls[(owner, fname)] = i + 1
            records.append((f"{owner} [{fname} call {i}]", out))
            return out
        return fused

    handles = [h for m in names for h in (m.register_forward_pre_hook(pre),
                                          m.register_forward_hook(post))]
    patched = []
    for mod_name, fnames in FUSED_SITES:
        mod = site_module(mod_name)
        for fname in fnames:
            patched.append((mod, fname, getattr(mod, fname)))
            setattr(mod, fname, wrap(getattr(mod, fname), fname))
    try:
        yield records
    finally:
        for h in handles:
            h.remove()
        for mod, fname, fn in patched:
            setattr(mod, fname, fn)


def loss_and_grad_norm(state, cfg: Config, batch, generator):
    """The training forward's loss and the global norm of its raw
    gradients at the state's weights; nothing is updated."""
    from .train.steps import cross_entropy_loss

    model = state.model
    model.zero_grad(set_to_none=True)
    with untouched(state):
        out = model(batch, generator=generator, train=True,
                    aimle_states=state.aimle_states)
        loss = cross_entropy_loss(out.logits, batch.labels,
                                  batch.sample_mask)
        loss.backward()
    sq = sum(float(p.grad.double().pow(2).sum())
             for p in model.parameters() if p.grad is not None)
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), sq ** 0.5


def localize(ckpt: str, max_steps: int = 200,
             seed_epoch: Optional[int] = None, device=None,
             say: Callable = print) -> dict:
    """Run the localizer on ``ckpt``; returns ``{"health": [...],
    "steps": [(epoch, step, loss, grad norm)], "offender": bool,
    "forward": [(name, nonfinite share)], "logits_finite": bool | None}``
    and prints what the JAX tool prints."""
    from .data.build import build_datasets
    from .models.build import resolve_device
    from .train.loop import Trainer
    from .train.steps import step_generator

    device = resolve_device(device)
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    cfg = Config.from_json(json.dumps(meta["config"]))
    epoch = int(meta.get("epoch", 0))
    say(f"config: sampler={cfg.sampler_type} epoch={epoch} "
        f"bs={cfg.batch_size}")
    data = build_datasets(cfg, pin_memory=device.type == "cuda")
    cfg = dataclasses.replace(cfg, num_answers=len(data.answers))
    trainer = Trainer(cfg, data, device=device)
    start_epoch, _ = trainer.resume(os.path.abspath(ckpt))
    state = trainer.state
    say(f"restored epoch {start_epoch - 1}")

    report = {"health": health(state), "steps": [], "offender": False,
              "forward": [], "logits_finite": None}
    for group, bad in report["health"]:
        say(f"{group}: {'NONFINITE in ' + str(bad[:10]) if bad else 'finite'}")

    epochs = ([seed_epoch] if seed_epoch is not None
              else [max(start_epoch - 1, 0), start_epoch])
    steps = 0
    offender = None
    for ep in epochs:
        for batch, _ in trainer._iter_split("train", shuffle=True,
                                            seed=cfg.seed + ep,
                                            drop_last=True):
            loss, gn = loss_and_grad_norm(
                state, cfg, batch,
                step_generator(cfg, state.step + steps, device))
            ok = bool(torch.isfinite(torch.tensor([loss, gn])).all())
            say(f"ep {ep} step {steps}: loss={loss:.4f} gnorm={gn:.3e} "
                f"finite={ok}")
            report["steps"].append((ep, steps, loss, gn))
            steps += 1
            if not ok:
                offender = (batch, state.step + steps - 1,
                            not torch.isfinite(torch.tensor(loss)).item())
                break
            if steps >= max_steps:
                break
        if offender or steps >= max_steps:
            break

    if offender is None:
        say("no nonfinite step found")
        return report
    report["offender"] = True
    batch, step, fwd_nan = offender
    say(f"offender found (forward nan={bool(fwd_nan)}); "
        "capturing module outputs...")
    records: list = []
    with untouched(state), record_outputs(state.model, records):
        out = state.model(batch, generator=step_generator(cfg, step, device),
                          train=True, aimle_states=state.aimle_states)
    bad = [(name, share) for name, share in
           ((n, nonfinite_share(o)) for n, o in records) if share > 0]
    report["forward"] = bad
    if bad:
        say("first nonfinite outputs (module call order):")
        for name, share in bad[:20]:
            say(f"  {name}: {share:.4f} nonfinite")
    else:
        report["logits_finite"] = bool(torch.isfinite(out.logits).all())
        say("forward outputs all finite (backward-only nan); logits "
            f"finite: {report['logits_finite']}")
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("python -m isubgvqa_tpu_torch.nan_localizer")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--max_steps", type=int, default=200)
    p.add_argument("--seed_epoch", type=int, default=None,
                   help="replay only this epoch's shuffle seed")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)
    return localize(args.ckpt, args.max_steps, args.seed_epoch, args.device,
                    say=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
