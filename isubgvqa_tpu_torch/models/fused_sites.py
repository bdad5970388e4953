"""The model modules that call a fused layer, and a switch that runs the
layers' plain PyTorch versions in place of their kernels."""

from __future__ import annotations

import contextlib
import importlib

# the model modules that call a fused layer, and the names they call
# (eval's, then training's); ``ops`` holds each name's ``<name>_plain``
FUSED_SITES = (
    ("mgat", ("fused_gat_layer", "fused_gat_layer_train")),
    ("question_encoder", ("fused_encoder_layer", "fused_encoder_layer_train")),
    ("question_decoder", ("fused_decoder_layer", "fused_decoder_layer_train")),
    ("scene_graph_encoder", ("fused_metalayer", "fused_metalayer_train")),
)


def site_module(name: str):
    """The model module ``name`` of :data:`FUSED_SITES`."""
    return importlib.import_module(f"{__package__}.{name}")


@contextlib.contextmanager
def plain_layers(plain: bool = True):
    """Inside, with ``plain``, the model's eval and training forward (and
    backward) run the fused layers' plain versions in place of their
    kernels: the control that tells a kernel's fault from the model's."""
    from .. import ops

    saved = [(site_module(m), n, getattr(site_module(m), n))
             for m, names in FUSED_SITES for n in names]
    try:
        if plain:
            for mod, n, _ in saved:
                setattr(mod, n, getattr(ops, n + "_plain"))
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
