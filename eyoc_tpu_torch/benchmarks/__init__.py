"""The SC2-PCR descriptor harness and the 3DMatch gt.log protocol
(counterpart of eyoc_tpu/benchmarks)."""

from eyoc_tpu_torch.benchmarks.descriptor_eval import (
    NpzPairLoader,
    classification_metrics,
    eval_descriptor_pairs,
    transformation_metrics,
)
