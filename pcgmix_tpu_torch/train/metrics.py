"""Recording-level evaluation metrics in numpy (counterpart:
``pcgmix_tpu/train/metrics.py``, which uses scikit-learn).

Test metrics are computed per *recording* (reference train_model.py:591-670):
per-segment softmax probabilities are grouped by wav, averaged and
argmaxed, or majority-voted with ties going to abnormal under
'(class_majority)'.  Train accuracy stays at segment level.  Confusion
counts, F1, precision and recall follow scikit-learn's definitions with
``zero_division=0``; ROC-AUC is the Mann–Whitney rank statistic with average
ranks for ties, which equals ``roc_auc_score``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.stats import rankdata


def aggregate_recordings(probs, wavs: Sequence, class_majority: bool = False) -> dict:
    """wav → (pred, mean_probs, num_segments), in order of first appearance."""
    by_wav: dict = {}
    for p, w in zip(probs, wavs):
        by_wav.setdefault(w, []).append(p)
    out = {}
    for w, plist in by_wav.items():
        arr = np.asarray(plist)
        mean = arr.mean(axis=0)
        if class_majority:
            votes = np.bincount(arr.argmax(axis=1), minlength=arr.shape[1])
            pred = int(votes.argmax())
            if votes[1] == votes.max() and (votes == votes.max()).sum() > 1:
                pred = 1
        else:
            pred = int(mean.argmax())
        out[w] = (pred, mean, len(plist))
    return out


def _binary_counts(targets, preds, positive):
    t = targets == positive
    p = preds == positive
    return int(np.sum(t & p)), int(np.sum(~t & p)), int(np.sum(t & ~p))


def _prf(tp, fp, fn):
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0
    return precision, recall, f1


def roc_auc(targets: np.ndarray, scores: np.ndarray) -> float:
    """Binary ROC-AUC as the rank statistic; NaN for a single-class split."""
    pos = targets == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(scores)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def recording_level_eval(probs, labels, wavs, class_majority: bool = False) -> dict:
    """Aggregate per-segment probabilities (N, C) into per-recording
    predictions and compute the reference metric set."""
    target_by_wav: dict = {}
    for t, w in zip(labels, wavs):
        target_by_wav.setdefault(w, int(t))
    agg = aggregate_recordings(probs, wavs, class_majority)
    wav_targets = np.asarray([target_by_wav[w] for w in agg])
    wav_preds = np.asarray([agg[w][0] for w in agg])
    wav_probs = np.asarray([agg[w][1] for w in agg])

    out = {"test_accuracy": float(np.mean(wav_targets == wav_preds) * 100.0)}
    out["test_wav_preds"] = {str(w): int(p) for w, p in zip(agg, wav_preds)}
    num_classes = np.asarray(probs).shape[1]
    if num_classes == 2:
        tp, fp, fn = _binary_counts(wav_targets, wav_preds, 1)
        tn = len(wav_targets) - tp - fp - fn
        precision, recall, f1 = _prf(tp, fp, fn)
        out.update({
            "test_specificity": float(tn / max(tn + fp, 1) * 100.0),
            "test_sensitivity": float(tp / max(tp + fn, 1) * 100.0),
            "test_f1": float(f1),
            "test_precision": float(precision),
            "test_recall": float(recall),
            "test_rocauc": roc_auc(wav_targets, wav_probs[:, 1]),
        })
    else:
        present = np.union1d(wav_targets, wav_preds)
        prf = np.array([_prf(*_binary_counts(wav_targets, wav_preds, c))
                        for c in present])
        aucs = [roc_auc((wav_targets == c).astype(int), wav_probs[:, c])
                for c in range(num_classes)]
        out.update({
            "test_specificity": float("nan"),
            "test_sensitivity": float("nan"),
            "test_f1": float(prf[:, 2].mean()),
            "test_precision": float(prf[:, 0].mean()),
            "test_recall": float(prf[:, 1].mean()),
            "test_rocauc": float(np.mean(aucs)),
        })
    return out


def segment_accuracy(preds, targets) -> float:
    """Train (segment-level) accuracy in percent."""
    return float(np.mean(np.asarray(preds) == np.asarray(targets)) * 100.0)


class PerformanceTracker:
    """The reference's performance dict, pickled at each plot epoch."""

    KEYS = (
        "steps", "epochs", "times", "train_loss", "train_accuracy",
        "test_loss", "test_accuracy", "test_specificity", "test_sensitivity",
        "test_precision", "test_recall", "test_f1", "test_rocauc",
        "test_wav_preds",
    )

    def __init__(self):
        self.dict = {k: [] for k in self.KEYS}

    def add(self, key: str, value):
        self.dict[key].append(value)
