"""Classical features and pipeline (counterpart: ``pcgmix_tpu/classical``):
the per-segment hand-crafted feature vector and its CSV rows, envelope
pruning, the rolling and single aggregations, the n_fraction subset files
and the augmentation-feature collectors, on a small pandas-compatible
table (``table.py``); the classifier bench (``run_experiment`` over
``_make_classifiers``: the mutual-information selection of
``selection.py`` and the eight estimators of ``estimators.py``, held to
scikit-learn 1.9.0 without importing it); and the CLI (``python -m
pcgmix_tpu_torch.classical``), which writes ``results.csv``."""

from pcgmix_tpu_torch.classical.experiment import (
    _make_classifiers,
    aggregate_features_rolling,
    aggregate_features_single,
    collect_augmentation_features,
    export_nfrac_wav_subsets,
    merge_augmentation_features,
    remove_segments_mean_envelope,
    run_experiment,
)
from pcgmix_tpu_torch.classical.features import extract_features, feature_vector_seg, write_csv
from pcgmix_tpu_torch.classical.selection import mutual_info, top_features
from pcgmix_tpu_torch.classical.table import Table, concat

__all__ = [
    "Table",
    "_make_classifiers",
    "aggregate_features_rolling",
    "aggregate_features_single",
    "collect_augmentation_features",
    "concat",
    "export_nfrac_wav_subsets",
    "extract_features",
    "feature_vector_seg",
    "merge_augmentation_features",
    "mutual_info",
    "remove_segments_mean_envelope",
    "run_experiment",
    "top_features",
    "write_csv",
]
