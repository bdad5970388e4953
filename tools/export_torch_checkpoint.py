#!/usr/bin/env python
"""Export a JAX run's orbax checkpoint as a checkpoint of the PyTorch port.

    python tools/export_torch_checkpoint.py <orbax_dir> <out_file>

``<orbax_dir>`` is a checkpoint that ``isubgvqa_tpu/train/checkpoint.py``
wrote (the whole train state: params, batch statistics, the optimizer's
state, the step, the AIMLE states) or that
``isubgvqa_tpu.convert.convert_reference_checkpoint`` wrote from an
upstream ``.pth`` (params and batch statistics only), beside its
``<orbax_dir>.meta.json``.  The tool writes ``<out_file>``, the port's
``torch.save`` payload (``isubgvqa_tpu_torch.convert.
train_payload_from_jax``), and ``<out_file>.meta.json`` with the JAX
meta's epoch and config, through the port's own checkpoint writer.  Then, on a card or with ``--device cpu``::

    python -m isubgvqa_tpu_torch.cli <flags> --resume <out_file>  # trains on
    python -m isubgvqa_tpu_torch.cli <flags> -e --resume <out_file>
    python -m isubgvqa_tpu_torch.run_token_coo --ckpt <out_file>

and ``Predictor.from_checkpoint(<out_file>)`` serves it.  A params-only
checkpoint gives a model-only payload: validation, serving and
explanation take it, a training resume refuses it.

It needs JAX and orbax (the machine that ran the JAX package), not a
card.  Restored without a target, orbax gives the optimizer's state as
plain containers: each NamedTuple (``SkipNonFiniteState``,
``ScaleByAdamState``, ``ScaleByScheduleState``) as a dict of its fields,
each tuple as a list, optax's ``EmptyState`` as ``None`` and the AIMLE
states' integer keys as strings.  Under ``make_optimizer(flat=True)``
(``optax.flatten``, the default) Adam's ``mu`` and ``nu`` are vectors in
``jax.flatten_util.ravel_pytree(params)`` order, unravelled here by that
unravel; under ``flat=False`` they are params-shaped trees already.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections.abc import Mapping

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, _REPO)


def _part(node, key):
    """``node[key]`` for a restored container: a dict (a NamedTuple's
    fields, or a tuple under string indices) or a list (a tuple)."""
    if isinstance(node, Mapping):
        return node[key] if key in node else node[str(key)]
    return node[key] if isinstance(key, int) else getattr(node, key)


def optimizer_state(opt_state, params):
    """``(mu, nu, count, notfinite_count)`` from the restored state of
    ``make_optimizer``: ``SkipNonFiniteState(notfinite_count,
    (clip's EmptyState, (ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count))))``, the moments as params-shaped
    numpy trees."""
    import jax
    import jax.flatten_util
    import numpy as np

    adam = _part(_part(_part(opt_state, "inner_state"), 1), 0)
    mu, nu = _part(adam, "mu"), _part(adam, "nu")
    if not isinstance(mu, Mapping):              # optax.flatten: one vector
        unravel = jax.flatten_util.ravel_pytree(params)[1]
        mu, nu = (jax.tree_util.tree_map(np.asarray, unravel(np.asarray(v)))
                  for v in (mu, nu))
    return (mu, nu, int(_part(adam, "count")),
            int(_part(opt_state, "notfinite_count")))


def export(orbax_dir: str, out_file: str) -> dict:
    """Restore ``orbax_dir`` and write ``out_file`` with its meta; returns
    the payload."""
    import orbax.checkpoint as ocp

    from isubgvqa_tpu_torch.convert import train_payload_from_jax
    from isubgvqa_tpu_torch.train.checkpoint import write_checkpoint

    orbax_dir = os.path.abspath(orbax_dir)
    meta_path = orbax_dir + ".meta.json"
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{meta_path} not found: the export takes "
                                f"the config from the JAX checkpoint's meta")
    with open(meta_path) as f:
        meta = json.load(f)
    config = json.dumps(meta["config"])
    raw = ocp.StandardCheckpointer().restore(orbax_dir)
    kw = {}
    if raw.get("opt_state"):
        mu, nu, count, notfinite = optimizer_state(raw["opt_state"],
                                                   raw["params"])
        kw = dict(mu=mu, nu=nu, count=count, notfinite_count=notfinite,
                  step=int(raw["step"]))
    payload = train_payload_from_jax(
        raw["params"], raw["batch_stats"], config,
        aimle_states=raw.get("aimle_states"), epoch=meta.get("epoch", -1),
        **kw)
    write_checkpoint(payload, out_file)
    return payload


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("orbax_dir", help="the JAX package's orbax checkpoint")
    p.add_argument("out_file", help="the port's checkpoint file to write")
    args = p.parse_args(argv)
    payload = export(args.orbax_dir, args.out_file)
    what = ("model only" if "optimizer" not in payload else
            f"step {payload['step']}, Adam count {payload['count']}")
    print(f"exported {args.orbax_dir} -> {args.out_file} (epoch "
          f"{payload['epoch']}, {what})")
    return payload


if __name__ == "__main__":
    main()
