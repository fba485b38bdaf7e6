"""Classical features and pipeline (counterpart: ``pcgmix_tpu/classical``):
the per-segment hand-crafted feature vector and its CSV rows, envelope
pruning, the rolling and single aggregations, the n_fraction subset files
and the augmentation-feature collectors, on a small pandas-compatible
table (``table.py``), and the CLI (``python -m pcgmix_tpu_torch.classical``).
The sklearn classifier bench (``run_experiment``) stays with the JAX
package: the GPU machine has no sklearn."""

from pcgmix_tpu_torch.classical.experiment import (
    aggregate_features_rolling,
    aggregate_features_single,
    collect_augmentation_features,
    export_nfrac_wav_subsets,
    merge_augmentation_features,
    remove_segments_mean_envelope,
)
from pcgmix_tpu_torch.classical.features import extract_features, feature_vector_seg, write_csv
from pcgmix_tpu_torch.classical.table import Table, concat

__all__ = [
    "Table",
    "aggregate_features_rolling",
    "aggregate_features_single",
    "collect_augmentation_features",
    "concat",
    "export_nfrac_wav_subsets",
    "extract_features",
    "feature_vector_seg",
    "merge_augmentation_features",
    "remove_segments_mean_envelope",
    "write_csv",
]
