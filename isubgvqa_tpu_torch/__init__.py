"""ISubGVQA in PyTorch for one NVIDIA H100: the port of the JAX
package ``isubgvqa_tpu``, which stays the reference.

It covers the batched eval forward of the config of record (k = 3,
masks (1, 1, 1, 0.15)) behind the serving
:class:`~isubgvqa_tpu_torch.serve.Predictor`, its training step and the
epoch loop with its checkpoints (:class:`~isubgvqa_tpu_torch.train.Trainer`,
``python -m isubgvqa_tpu_torch.cli``), and explanation extraction
(``python -m isubgvqa_tpu_torch.run_token_coo``), under each of the four
samplers (gumbel, imle, aimle, simple), with the eight fused layers of
those paths as hand-written CUDA kernels (:mod:`.ops`, sources in
``csrc/``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .config import Config

__all__ = ["Config"]
