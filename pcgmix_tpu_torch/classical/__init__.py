"""Classical features (counterpart: ``pcgmix_tpu/classical``): the
per-segment hand-crafted feature vector and its CSV rows.  The JAX
package's pruning, aggregation and sklearn bench (``experiment.py``,
``__main__.py``) are not ported."""

from pcgmix_tpu_torch.classical.features import extract_features, feature_vector_seg, write_csv

__all__ = ["extract_features", "feature_vector_seg", "write_csv"]
