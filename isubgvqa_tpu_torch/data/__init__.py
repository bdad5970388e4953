"""Host-side data layer of the port: GQA questions, scene graphs,
vocabularies, tokenization and padded fixed-shape batching."""

from .vocab import SceneGraphVocab
from .tokenizer import build_tokenizer, HashWordTokenizer
from .scene_graph import SceneGraphStore, GraphArrays, convert_scene_graph
from .gqa import GQADataset, AnswerMap, Sample, build_text_vocab
from .batching import (BatchMeta, BucketSpec, Collator, GraphBatch,
                       group_multistep, iterate_batches,
                       iterate_batches_bucketed, prefetch, route_to_buckets)
from .build import DataBundle, build_bucket_collators, build_datasets
from .synthetic import SyntheticGQA

__all__ = [
    "SceneGraphVocab", "build_tokenizer", "HashWordTokenizer",
    "SceneGraphStore", "GraphArrays", "convert_scene_graph", "GQADataset",
    "AnswerMap", "Sample", "build_text_vocab", "BatchMeta", "BucketSpec",
    "Collator", "GraphBatch", "group_multistep", "iterate_batches",
    "iterate_batches_bucketed", "prefetch", "route_to_buckets", "DataBundle",
    "build_bucket_collators", "build_datasets", "SyntheticGQA",
]
