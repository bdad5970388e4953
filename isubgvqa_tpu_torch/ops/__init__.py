"""Kernels of the port.

Each fused layer lives in its own module beside its plain PyTorch
version and a launch counter (``<wrapper>.launches``).  Eval:

* :func:`~.gat_kernel.fused_gat_layer` (replaces the Pallas
  ``ops/pallas/gat_kernel.py:fused_gat_layer``);
* :func:`~.text_kernel.fused_encoder_layer` and
  :func:`~.text_kernel.fused_decoder_layer` (``text_kernel.py``);
* :func:`~.metalayer_kernel.fused_metalayer` (``metalayer_kernel.py``).

Training, each a ``torch.autograd.Function`` whose forward and backward
launch kernels, counted apart (``.launches`` and ``.bwd_launches``):

* :func:`~.gat_train.fused_gatconv` (``ops/pallas/gat_train.py``);
* :func:`~.metalayer_train.fused_metalayer_train`
  (``metalayer_train.py``);
* :func:`~.text_train.fused_encoder_layer_train` and
  :func:`~.text_train.fused_decoder_layer_train` (``text_train.py``).

The CUDA sources are under ``isubgvqa_tpu_torch/csrc/``; :mod:`._lib`
builds and loads them on first use.  The segment reductions and the
flat <-> dense conversions of the JAX package's ``ops`` are exported
here too, as its ``ops/__init__.py`` exports them.
"""

from .dense import dense_topk_mask, from_dense_batch, to_dense_batch
from .gat_kernel import fused_gat_layer, fused_gat_layer_plain
from .gat_train import fused_gatconv, fused_gatconv_plain
from .metalayer_kernel import fused_metalayer, fused_metalayer_plain
from .metalayer_train import (fused_metalayer_train,
                              fused_metalayer_train_plain)
from .segment import (segment_max, segment_mean, segment_min,
                      segment_normalize, segment_softmax, segment_sum)
from .text_kernel import (fused_decoder_layer, fused_decoder_layer_plain,
                          fused_encoder_layer, fused_encoder_layer_plain)
from .text_train import (fused_decoder_layer_train,
                         fused_decoder_layer_train_plain,
                         fused_encoder_layer_train,
                         fused_encoder_layer_train_plain)

EVAL_WRAPPERS = (fused_gat_layer, fused_encoder_layer, fused_decoder_layer,
                 fused_metalayer)
TRAIN_WRAPPERS = (fused_gatconv, fused_metalayer_train,
                  fused_encoder_layer_train, fused_decoder_layer_train)
WRAPPERS = EVAL_WRAPPERS + TRAIN_WRAPPERS


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in TRAIN_WRAPPERS:
        fn.bwd_launches = 0


def launch_counts(wrappers=WRAPPERS) -> dict:
    """``{name: forward launches}``, and ``{name + "_bwd": backward
    launches}`` for the training wrappers among ``wrappers``."""
    counts = {fn.__name__: fn.launches for fn in wrappers}
    counts.update({fn.__name__ + "_bwd": fn.bwd_launches
                   for fn in wrappers if fn in TRAIN_WRAPPERS})
    return counts


__all__ = [
    "fused_gat_layer", "fused_gat_layer_plain", "fused_metalayer",
    "fused_metalayer_plain", "fused_encoder_layer",
    "fused_encoder_layer_plain", "fused_decoder_layer",
    "fused_decoder_layer_plain", "fused_gatconv", "fused_gatconv_plain",
    "fused_metalayer_train", "fused_metalayer_train_plain",
    "fused_encoder_layer_train", "fused_encoder_layer_train_plain",
    "fused_decoder_layer_train", "fused_decoder_layer_train_plain",
    "EVAL_WRAPPERS", "TRAIN_WRAPPERS", "WRAPPERS", "reset_launch_counts",
    "launch_counts", "segment_sum", "segment_mean", "segment_max",
    "segment_min", "segment_softmax", "segment_normalize", "to_dense_batch",
    "from_dense_batch", "dense_topk_mask",
]
