"""Framework configuration for the PyTorch port.

The same frozen dataclass as ``isubgvqa_tpu/config.py`` — same fields,
same defaults, same ``to_json``/``from_json`` — so a config written by
either package loads in the other.  The port keeps its own copy because
importing the JAX package pulls in jax.

Fields that only steer the TPU build (``kernel_pack``, ``data_axis``,
``model_axis``, ``donate_state``) are kept for the JSON round trip and
ignored here.  ``use_pallas`` keeps its name for the
JSON; in the port it means "run the hand-written CUDA kernels".  On a
CUDA device the kernels always run, and ``use_pallas=False`` there is
an error rather than a silent switch to the plain PyTorch path.

One default differs: ``meta_dir`` defaults to ``$ISUBGVQA_META_DIR``
or ``""`` (no meta assets, so the synthetic vocabulary and answer map).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- model
    mgat_layers: int = 4
    general_hidden_dim: int = 300
    text_emb_dim: int = 512
    num_answers: int = 1842
    encoder_layers: int = 4
    decoder_layers: int = 3
    num_heads: int = 8
    gat_heads: int = 4
    dropout: float = 0.1
    head_dropout: float = 0.2
    mask_dropout: float = 0.2
    mgat_masks: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.15)
    use_instruction: bool = True
    use_masking: bool = True
    use_topk: bool = True
    interpretable_mode: bool = False
    concat_instr: bool = False
    use_all_instrs: bool = False
    use_global_mask: bool = False
    text_sampling: bool = False
    node_classification: bool = False

    # ---- sampler
    sampler_type: Optional[str] = None      # imle | aimle | simple | gumbel | None
    sample_k: Optional[int] = None
    nb_samples: int = 1
    alpha: float = 1.0
    beta: float = 10.0
    tau: float = 1.0

    # ---- data
    data_dir: str = "./data"
    meta_dir: str = os.environ.get("ISUBGVQA_META_DIR", "")
    glove_path: Optional[str] = None
    clip_weights: Optional[str] = None
    clip_tokenizer_dir: Optional[str] = None
    text_vocab_size: int = 49408
    question_len: int = 32
    max_nodes_per_graph: int = 128
    max_edges_per_graph: int = 384
    bucket_node_caps: Tuple[int, ...] = (16, 32, 64, 128)
    bucket_question_lens: Tuple[int, ...] = (16,)
    synthetic: bool = False
    synthetic_size: int = 2048
    synthetic_shape_mix: str = "small"

    # ---- training
    batch_size: int = 256
    eval_batch_factor: int = 4
    lr: float = 5e-5
    scale_factor: int = 1
    epochs: int = 100
    start_epoch: int = 0
    warmup_epochs: int = 10
    warmup_start_lr: float = 1e-6
    lr_gamma: float = 0.98
    grad_clip_norm: float = 2.0
    seed: int = 3407
    print_freq: int = 50
    evaluate: bool = False
    pre_eval: bool = False
    resume: str = ""
    output_dir: str = "./outputdir"
    log_name: str = "gtsg.log"
    experiment_name: Optional[str] = None
    profile_dir: str = ""

    # ---- execution
    compute_dtype: str = "bfloat16"         # activation / weight dtype
    param_dtype: str = "float32"
    data_axis: str = "data"                 # TPU only, kept for the JSON
    model_axis: str = "model"               # TPU only, kept for the JSON
    num_data_shards: Optional[int] = None
    model_parallel: int = 1
    use_pallas: bool = True                 # here: the CUDA kernels
    kernel_pack: Union[int, str, None] = "auto"   # TPU only
    donate_state: bool = True               # TPU only
    # optimizer updates per dispatch: >1 groups that many same-shape
    # batches (data/batching.py:group_multistep) and runs each group's
    # steps as one CUDA graph replay on the card (a loop elsewhere:
    # train/steps.py:make_multistep_train_step); 1 = one step at a time
    multistep: int = 1

    def scaled(self) -> "Config":
        """Apply the reference's linear batch / lr scaling
        (``main.py:54-55``)."""
        return dataclasses.replace(
            self,
            batch_size=self.batch_size * self.scale_factor,
            lr=self.lr * self.scale_factor,
            scale_factor=1,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in fields}
        for name in ("mgat_masks", "bucket_node_caps", "bucket_question_lens"):
            if d.get(name) is not None:
                d[name] = tuple(d[name])
        return cls(**d)
