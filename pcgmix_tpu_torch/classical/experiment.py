"""Classical pipeline stages on the host (counterpart:
``pcgmix_tpu/classical/experiment.py``): segment pruning, the rolling and
the single aggregation, the n_fraction subset files and the
augmentation-feature collectors, on ``classical.table.Table``.

Each result equals the JAX package's pandas result bit for bit: means and
SDs sum as pandas' ``nanops`` do (numpy's pairwise sum over one column),
and the rolling window runs pandas' online algorithm
(``_libs/window/aggregations.pyx``: ``roll_mean`` with separate Kahan
compensations for adding and removing and ``calc_mean``'s rules for a run
of equal values and for the sign; ``roll_var``'s Welford updates,
``calc_var``'s zero rules and its fresh start of a window where a removal
cancelled nearly all of the squared deviations) over the whole tiled
sequence, from its first row.

The classifier bench (:func:`run_experiment` over
:func:`_make_classifiers`) runs the port's own estimators
(``classical/estimators.py``) and mutual-information selection
(``classical/selection.py``), held to scikit-learn 1.9.0.  XGBoost is not
in the bench: neither the CPU machine nor the GPU machine has ``xgboost``,
so the JAX package's bench has the same eight rows there.
"""

from __future__ import annotations

import glob
import os
import random
from typing import Optional, Sequence

import numpy as np

from pcgmix_tpu_torch.classical.table import Table, concat

NON_FEATURES = ["class", "wav", "segment", "sig_qual", "split"]


# --------------------------------------------------------------------------- #
# pandas' reductions
# --------------------------------------------------------------------------- #


def _as_float(values: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.float64)


def nanmean(values: np.ndarray) -> float:
    """``Series.mean()`` (``nanops.nanmean``): NaN as 0 in numpy's sum, over
    the count of the rest."""
    v = _as_float(values)
    mask = np.isnan(v)
    count = float(len(v) - mask.sum())
    total = np.where(mask, 0.0, v).sum()
    return float(total / count) if count > 0 else float("nan")


def nanstd(values: np.ndarray, ddof: int = 1) -> float:
    """``Series.std()`` (``nanops.nanvar``'s two passes, then ``sqrt``)."""
    v = _as_float(values)
    mask = np.isnan(v)
    count = float(len(v) - mask.sum())
    if count <= ddof:
        return float("nan")
    v = np.where(mask, 0.0, v)
    avg = v.sum() / count
    sqr = (avg - v) ** 2
    sqr[mask] = 0.0
    return float(np.sqrt(sqr.sum() / (count - ddof)))


def _window_bounds(n: int, window: int) -> tuple[np.ndarray, np.ndarray]:
    """pandas' ``FixedWindowIndexer``: window i covers rows [start, end)."""
    end = np.arange(1, n + 1)
    return np.clip(end - window, 0, n), end


def roll_mean(values: np.ndarray, window: int) -> np.ndarray:
    """``DataFrame.rolling(window).mean()`` on (rows, columns) float64, each
    column on its own (pandas' ``roll_mean``)."""
    n, k = values.shape
    start, end = _window_bounds(n, window)
    out = np.empty((n, k))
    z = np.zeros(k)
    with np.errstate(invalid="ignore"):
        for i in range(n):
            s, e = start[i], end[i]
            if i == 0 or s >= end[i - 1]:
                prev = values[s].copy()
                same = np.zeros(k, np.int64)
                total, comp_add, comp_rem = z.copy(), z.copy(), z.copy()
                nobs, neg = np.zeros(k, np.int64), np.zeros(k, np.int64)
                removes, adds = (), range(s, e)
            else:
                removes, adds = range(start[i - 1], s), range(end[i - 1], e)
            for j in removes:
                val = values[j]
                ok = val == val
                nobs -= ok
                y = -val - comp_rem
                t = total + y
                comp_rem = np.where(ok, t - total - y, comp_rem)
                total = np.where(ok, t, total)
                neg -= ok & np.signbit(val)
            for j in adds:
                val = values[j]
                ok = val == val
                nobs += ok
                y = val - comp_add
                t = total + y
                comp_add = np.where(ok, t - total - y, comp_add)
                total = np.where(ok, t, total)
                neg += ok & np.signbit(val)
                same = np.where(ok, np.where(val == prev, same + 1, 1), same)
                prev = np.where(ok, val, prev)
            with np.errstate(divide="ignore"):
                mean = total / nobs
            mean = np.where(same >= nobs, prev,
                            np.where((neg == 0) & (mean < 0), 0.0,
                                     np.where((neg == nobs) & (mean > 0), 0.0, mean)))
            out[i] = np.where((nobs >= window) & (nobs > 0), mean, np.nan)
    return out


# pandas' roll_var starts a window afresh where removing a row left less
# than this share of the sum of squared deviations before it
_VAR_RESTART = 1000 * np.finfo(np.float64).eps


def _var_add(st: dict, val: np.ndarray) -> None:
    """pandas' ``add_var``, for each column at once."""
    ok = val == val
    st["nobs"] = st["nobs"] + ok
    st["same"] = np.where(ok, np.where(val == st["prev"], st["same"] + 1, 1), st["same"])
    st["prev"] = np.where(ok, val, st["prev"])
    mean, comp, nobs = st["mean"], st["comp_add"], st["nobs"]
    prev_mean = mean - comp
    y = val - comp
    t = y - mean
    new_comp = t + mean - y
    new_mean = np.where(nobs != 0, mean + t / nobs, 0.0)
    new_ssq = st["ssq"] + (val - prev_mean) * (val - new_mean)
    st["comp_add"] = np.where(ok, new_comp, comp)
    st["mean"] = np.where(ok, new_mean, mean)
    st["ssq"] = np.where(ok, new_ssq, st["ssq"])


def _var_remove(st: dict, val: np.ndarray) -> None:
    """pandas' ``remove_var``, for each column at once."""
    ok = val == val
    st["nobs"] = st["nobs"] - ok
    live = ok & (st["nobs"] != 0)
    mean, comp = st["mean"], st["comp_rem"]
    prev_mean = mean - comp
    y = val - comp
    t = y - mean
    new_comp = t + mean - y
    new_mean = mean - t / st["nobs"]
    new_ssq = st["ssq"] - (val - prev_mean) * (val - new_mean)
    st["comp_rem"] = np.where(live, new_comp, comp)
    st["mean"] = np.where(live, new_mean, np.where(ok, 0.0, mean))
    st["ssq"] = np.where(live, new_ssq, np.where(ok, 0.0, st["ssq"]))


def _var_window(values: np.ndarray, s: int, e: int) -> dict:
    """The state after adding rows [s, e) to an empty window."""
    k = values.shape[1]
    st = {"prev": values[s].copy(), "same": np.zeros(k, np.int64)}
    for key in ("mean", "ssq", "nobs", "comp_add", "comp_rem"):
        st[key] = np.zeros(k)
    for j in range(s, e):
        _var_add(st, values[j])
    return st


def roll_var(values: np.ndarray, window: int, ddof: int = 1) -> np.ndarray:
    """``DataFrame.rolling(window).var()`` on (rows, columns) float64, each
    column on its own (pandas' ``roll_var``: Welford with Kahan
    compensations, a window started afresh where a removal cancelled all
    but ``_VAR_RESTART`` of the squared deviations)."""
    n, k = values.shape
    start, end = _window_bounds(n, window)
    minp = max(window, 1)
    out = np.empty((n, k))
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(n):
            s, e = start[i], end[i]
            if i == 0 or s >= end[i - 1]:
                st = _var_window(values, s, e)
            else:
                before = st["ssq"]
                for j in range(start[i - 1], s):
                    _var_remove(st, values[j])
                restart = st["ssq"] < _VAR_RESTART * before if s > start[i - 1] else None
                for j in range(end[i - 1], e):
                    _var_add(st, values[j])
                if restart is not None and restart.any():
                    fresh = _var_window(values, s, e)
                    st = {key: np.where(restart, fresh[key], v) for key, v in st.items()}
            nobs = st["nobs"]
            var = np.where(st["same"] >= nobs, 0.0, st["ssq"] / (nobs - ddof))
            var = np.where(var < 0, 0.0, var)
            out[i] = np.where((nobs >= minp) & (nobs > ddof), var, np.nan)
    return out


# --------------------------------------------------------------------------- #
# pruning and aggregation
# --------------------------------------------------------------------------- #


def _recordings(features: Table) -> list[np.ndarray]:
    """Each recording's row indices, in order of first appearance."""
    groups: dict = {}
    for i, wav in enumerate(features["wav"].tolist()):
        groups.setdefault(wav, []).append(i)
    return [np.asarray(rows, dtype=np.int64) for rows in groups.values()]


def remove_segments_mean_envelope(features: Table, std_factor: float = 1.4) -> Table:
    """Drop segments whose MeanEnv_RR lies outside mean ± SD·std_factor of
    their recording (classical.py:115-146).  A one-segment recording has SD
    NaN and is kept."""
    env = features["MeanEnv_RR"]
    kept = []
    for rows in _recordings(features):
        x = _as_float(env[rows])
        mu, sd = nanmean(x), nanstd(x)
        out = (x < mu - sd * std_factor) | (x > mu + sd * std_factor)
        kept.append(rows[~out])
    return features.take(np.concatenate(kept) if kept else np.zeros(0, np.int64))


def _feature_columns(features: Table) -> list[str]:
    return [c for c in features.columns if c not in NON_FEATURES]


def _clean_recording(rows: Table) -> Table:
    """±inf → NaN → the column's mean, ``segment`` as int, sorted by it."""
    rows = rows.copy()
    for c in _feature_columns(rows):
        v = rows[c]
        if v.dtype.kind == "f":
            v = np.where(np.isinf(v), np.nan, v)
            rows[c] = np.where(np.isnan(v), nanmean(v), v)
    rows["segment"] = rows["segment"].astype(np.int64)
    return rows.sort_values("segment")


def aggregate_features_rolling(features: Table, window: int = 2) -> Table:
    """Append cyclic rolling-window mean (m_) and SD (sd_) columns per
    recording (classical.py:165-200): each recording's rows are tiled so the
    window wraps around the cycle sequence, and its last n rows are kept."""
    cols = _feature_columns(features)
    out = []
    for rows in _recordings(features):
        clean = _clean_recording(features.take(rows))
        n = len(clean)
        tiled = concat([clean] * int(np.ceil((n + window) / n)))
        values = np.stack([_as_float(tiled[c]) for c in cols], axis=1) if cols else \
            np.zeros((len(tiled), 0))
        values = np.where(np.isinf(values), np.nan, values)
        mean = roll_mean(values, window)[-n:]
        sd = np.sqrt(roll_var(values, window)[-n:])
        last = tiled.take(slice(len(tiled) - n, None))
        for j, c in enumerate(cols):
            last[f"m_{c}"] = mean[:, j]
        for j, c in enumerate(cols):
            last[f"sd_{c}"] = sd[:, j]
        out.append(last)
    return concat(out)


def aggregate_features_single(features: Table) -> Table:
    """One row per recording with whole-recording m_/sd_ aggregates
    (classical.py:202-243)."""
    cols = _feature_columns(features)
    out = []
    for rows in _recordings(features):
        clean = _clean_recording(features.take(rows))
        head = clean.take(slice(0, 1))
        for c in cols:
            head[f"m_{c}"] = np.array([nanmean(clean[c])])
        for c in cols:
            head[f"sd_{c}"] = np.array([nanstd(clean[c])])
        out.append(head)
    return concat(out)


# --------------------------------------------------------------------------- #
# n_fraction subsets and the augmentation-feature collectors
# --------------------------------------------------------------------------- #


def export_nfrac_wav_subsets(
    dataset: dict,
    out_dir: str,
    n_fractions: Sequence[float],
    seed_datas_by_nfrac: Optional[dict] = None,
    dataset_name: str = "PhysioNet",
) -> list[str]:
    """Write the per-(seed_data, n_fraction) train-wav subset files the
    classical experiments consume (classical.ipynb cell 21): for each grid
    point the sorted train recordings and their segment count
    (``{dataset}_seed(data)={sd}_nfrac={nf}_valid=False.txt`` and
    ``..._num-segs.txt``), plus ``{dataset}_test.txt``.  Existing files are
    skipped.  ``seed_datas_by_nfrac`` defaults to the published grids
    (``exp.robust.SEED_DATA_GRIDS``).  Returns the paths written."""
    from pcgmix_tpu_torch.data.physionet import physionet_split
    from pcgmix_tpu_torch.exp.robust import SEED_DATA_GRIDS

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for nf in n_fractions:
        if seed_datas_by_nfrac and nf in seed_datas_by_nfrac:
            sds = seed_datas_by_nfrac[nf]
        else:
            sds = SEED_DATA_GRIDS[nf][0] if nf in SEED_DATA_GRIDS else [1100001]
        for sd in sds:
            stem = f"{dataset_name}_seed(data)={sd}_nfrac={nf}_valid=False"
            fn = os.path.join(out_dir, stem + ".txt")
            fn2 = os.path.join(out_dir, stem + "_num-segs.txt")
            if os.path.exists(fn) and os.path.exists(fn2):
                continue
            split = physionet_split(dataset, "train", n_fraction=nf, seed_data=sd,
                                    train_balance=True)
            np.savetxt(fn, sorted(set(split.wav)), fmt="%s")
            np.savetxt(fn2, [len(split)])
            written += [fn, fn2]
    test_fn = os.path.join(out_dir, f"{dataset_name}_test.txt")
    if not os.path.exists(test_fn):
        test = physionet_split(dataset, "test")
        np.savetxt(test_fn, sorted(set(test.wav)), fmt="%s")
        written.append(test_fn)
    return written


def _step_csvs(run_dir: str) -> list[str]:
    cs = os.path.join(run_dir, "classical_space")
    number = len(glob.glob(os.path.join(cs, "train_*.csv")))
    return [os.path.join(cs, f"train_{i}.csv") for i in range(number)]


def collect_augmentation_features(run_dir: str) -> Table:
    """Concatenate a run's per-step ``classical_space/train_{i}.csv`` dumps
    in step order into one table (classical.ipynb cell 27)."""
    return concat([Table.read_csv(p) for p in _step_csvs(run_dir)])


def merge_augmentation_features(
    run_dir: str,
    base_features: Table,
    out_dir: str,
    tag: str,
    steps_per_epoch: int = 2,
    band_suffix: str = "filtBandIIR(ZP)4-25-400_normRMS",
    swap_base_labels: bool = True,
) -> list[str]:
    """Fold a run's augmented-instance feature dumps into a base feature
    table, writing one cumulative snapshot per epoch (classical.ipynb cell
    25).  Each batch: drop sig_qual/split, wav → recording with the band
    suffix, recordingName / patientID derived from it, segment=999; the
    base (a copy) gets the UMC label swap (``class`` 0↔1) and rows sort by
    (recording, segment), stably.  A snapshot every ``steps_per_epoch``
    batches.  Returns the snapshot paths (part=0 is the base alone)."""
    os.makedirs(out_dir, exist_ok=True)
    fts = base_features.copy()
    if swap_base_labels:
        c = fts["class"]
        fts["class"] = np.where(c == 0, 1, np.where(c == 1, 0, c)).astype(c.dtype)
    fts = fts.sort_values(["recording", "segment"])
    fn = os.path.join(out_dir, f"UMC_augmentation_fts_{tag}_part=0.csv")
    fts.to_csv(fn)
    written = [fn]
    for i, path in enumerate(_step_csvs(run_dir)):
        batch = Table.read_csv(path).drop(["sig_qual", "split"]).rename({"wav": "recording"})
        recording = [f"{x}_{band_suffix}" for x in batch["recording"].tolist()]
        batch["recording"] = _strings(recording)
        batch["recordingName"] = _strings([f"{x}.wav" for x in recording])
        batch["patientID"] = _strings([f"ID_{x.split('_')[0]}" for x in recording])
        batch["segment"] = 999
        fts = concat([fts, batch]).sort_values(["recording", "segment"])
        if i % steps_per_epoch == steps_per_epoch - 1:
            part = (i + 1) // steps_per_epoch
            fn = os.path.join(out_dir, f"UMC_augmentation_fts_{tag}_part={part}.csv")
            fts.to_csv(fn)
            written.append(fn)
    return written


def _strings(values: list) -> np.ndarray:
    col = np.empty(len(values), dtype=object)
    col[:] = values
    return col


# --------------------------------------------------------------------------- #
# summaries, folds and the grids of the classifier bench
# --------------------------------------------------------------------------- #


def mean_confidence_interval(data, confidence: float = 0.95):
    """(mean, low, high) t-interval (classical.py:1295-1300)."""
    import scipy.stats

    a = 1.0 * np.asarray(data)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, len(a) - 1)
    return m, m - h, m + h


def mean_sd_95ci(data) -> str:
    """'mean (SD; low-high)' summary string (classical.py:1303-1309)."""
    m, lo, hi = mean_confidence_interval(data)
    return f"{np.mean(data):.5f} ({np.std(data):.2f}; {lo:.2f}-{hi:.2f})"


def generate_ncv_folds(wavs, fold_number: int = 5, seed: int = 4):
    """Seeded shuffled interleaved CV partitions over recordings
    (classical.py:1312-1317)."""
    wavs = list(wavs)
    random.Random(seed).shuffle(wavs)
    return [wavs[i::fold_number] for i in range(fold_number)]


def search_space_grid(clf_name: str, seed: int) -> dict:
    """Hyperparameter grids for fine-tuning (classical.py:1320-1388)."""
    grids = {
        "LogisticRegression": dict(
            solver=["newton-cg", "lbfgs", "liblinear"],
            penalty=["none", "l1", "l2", "elasticnet"],
            C=np.linspace(0.05, 2, 40), max_iter=[50, 100, 150, 200],
            random_state=[seed],
        ),
        "DecisionTreeClassifier": dict(
            criterion=["gini", "entropy"], splitter=["best", "random"],
            min_samples_split=list(range(4, 91, 6)),
            max_features=["sqrt", "log2"], random_state=[seed],
        ),
        "RandomForestClassifier": dict(
            n_estimators=[20, 80, 140, 200], criterion=["gini", "entropy"],
            min_samples_split=list(range(4, 91, 6)),
            max_features=["sqrt", "log2"], random_state=[seed],
        ),
        "KNeighborsClassifier": dict(
            n_neighbors=[3, 9, 15, 21, 27, 37, 43, 49, 55, 61, 67, 73, 79,
                         85, 91, 97, 1],
            weights=["uniform", "distance"],
            metric=["euclidean", "manhattan", "minkowski"],
        ),
        "GaussianNB": dict(var_smoothing=np.logspace(0, -9, num=100)),
        "SVC": dict(
            svc__C=np.linspace(0.05, 3, 60),
            svc__kernel=["linear", "poly", "rbf", "sigmoid"],
            svc__gamma=["auto"], svc__probability=[True],
            svc__random_state=[seed],
        ),
        "SGDClassifier": dict(
            loss=["log_loss"], penalty=["l2", "l1", "elasticnet"],
            alpha=np.logspace(0, -9, num=100), random_state=[seed],
        ),
        "GradientBoostingClassifier": dict(
            learning_rate=[0.01, 0.025, 0.05, 0.075, 0.1, 0.15, 0.2],
            n_estimators=[20, 60, 100, 140, 180, 200],
            min_samples_split=np.linspace(0.1, 0.5, 12),
            max_features=["sqrt", "log2"], random_state=[seed],
        ),
    }
    return grids.get(clf_name, {})


# --------------------------------------------------------------------------- #
# the classifier bench (classical.py:1391-1617)
# --------------------------------------------------------------------------- #

METRICS = ["Specificity", "Sensitivity", "Accuracy", "Precision", "Recall", "F1", "ROCAUC"]
# the reference's feature filter (classical.py:1438-1448): keep the m_/sd_
# aggregates, drop RR-derived, MaxAmp, EnvInt, dwt5, chroma and mel
_DROPPED = ("_RR", "MaxAmp", "EnvInt", "dwt5", "chroma", "melspectrogram1")


def _make_classifiers(seed: int, device="cuda") -> list:
    """(estimator, name, abbreviation) of the bench, in the JAX package's
    order; Gaussian NB and k-NN run on ``device``, the rest on the host."""
    from pcgmix_tpu_torch.classical import estimators as est

    return [
        (est.LogisticRegression(), "LogisticRegression", "LR"),
        (est.DecisionTreeClassifier(seed), "DecisionTreeClassifier", "DT"),
        (est.RandomForestClassifier(seed), "RandomForestClassifier", "RF"),
        (est.KNeighborsClassifier(device=device), "KNeighborsClassifier", "KN"),
        (est.GaussianNB(device=device), "GaussianNB", "GNB"),
        (est.SVC(seed), "SVC", "SVC"),
        (est.SGDClassifier(seed), "SGDClassifier", "SGD"),
        (est.GradientBoostingClassifier(seed), "GradientBoostingClassifier", "GB"),
    ]


def group_means(keys: np.ndarray, columns: list) -> tuple[list, list]:
    """``DataFrame.groupby(keys, sort=False).mean()``: the groups in order
    of first appearance, each column's group sum with Kahan compensation
    over the count (pandas' ``_libs/groupby.pyx::group_mean``)."""
    index: dict = {}
    codes = np.array([index.setdefault(k, len(index)) for k in keys.tolist()], dtype=np.int64)
    means = []
    for col in columns:
        col = np.asarray(col, dtype=np.float64)
        total, comp = np.zeros(len(index)), np.zeros(len(index))
        count = np.zeros(len(index))
        for g, val in zip(codes.tolist(), col.tolist()):
            if val != val:
                continue
            count[g] += 1
            y = val - comp[g]
            t = total[g] + y
            comp[g] = t - total[g] - y
            if comp[g] != comp[g]:
                comp[g] = 0.0
            total[g] = t
        with np.errstate(invalid="ignore", divide="ignore"):
            means.append(np.where(count > 0, total / count, np.nan))
    return list(index), means


def _matrix(table: Table, names: list) -> np.ndarray:
    """``DataFrame[names].to_numpy()``: float64 columns, column-major as
    pandas lays a frame's block out.  The layout is part of the result: the
    reference's column statistics (the mutual information's scaling, the
    standard scaler) reduce a column-major matrix pairwise and a row-major
    one row by row."""
    return np.stack([np.asarray(table[c], dtype=np.float64) for c in names], axis=0).T


def _scores(y: np.ndarray, pred: np.ndarray, proba1: np.ndarray) -> dict:
    from pcgmix_tpu_torch.train.metrics import roc_auc

    tp = int(np.sum((y == 1) & (pred == 1)))
    tn = int(np.sum((y == 0) & (pred == 0)))
    fp = int(np.sum((y == 0) & (pred == 1)))
    fn = int(np.sum((y == 1) & (pred == 0)))
    return {
        "Specificity": tn / max(tn + fp, 1),
        "Sensitivity": tp / max(tp + fn, 1),
        "Accuracy": float(np.average(y == pred)),
        "Precision": tp / (tp + fp) if tp + fp else 0.0,
        "Recall": tp / (tp + fn) if tp + fn else 0.0,
        "F1": 2.0 * tp / (2.0 * tp + fn + fp) if tp + fn + fp else 0.0,
        "ROCAUC": roc_auc(y, proba1) if len(np.unique(y)) > 1 else float("nan"),
    }


def run_experiment(features: Table, *, keep_only_sd_m_fts: bool = True,
                   majority_vote_prediction: bool = True,
                   train_wavs: Optional[Sequence[str]] = None, kb_num: int = 40,
                   seed: int = 4, device="cuda", record: Optional[dict] = None) -> Table:
    """The train/test bench over the eight classifiers (counterpart:
    ``pcgmix_tpu.classical.run_experiment``, classical.py:1391-1617).

    ``features``: the aggregated table with the NON_FEATURES columns;
    ``train_wavs``: the train recordings to keep (an n_fraction subset,
    classical.py:1424-1428).  The top ``kb_num`` features by mutual
    information on the train rows feed every classifier; with
    ``majority_vote_prediction`` a test recording's labels and class
    probabilities are the means over its rows and its prediction their
    argmax.  Returns one metrics row a classifier.  The mutual information,
    Gaussian NB and k-NN run on ``device`` ("cuda" without a card raises).
    ``record``, when given, receives ``selected`` (the chosen features in
    order), ``proba`` (each classifier's test-row probabilities) and
    ``ms`` (the host milliseconds of the mutual information, ``MI``, and of
    each classifier's fit and predictions, the card's work waited for)."""
    import time

    from pcgmix_tpu_torch.classical.selection import mutual_info, top_features
    from pcgmix_tpu_torch.train.loop import resolve_device

    dev = resolve_device(str(device))

    def tick():
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        return time.perf_counter()

    fts = features.copy()
    split = fts["split"]
    if train_wavs is not None:
        keep = set(train_wavs)
        in_train = np.array([w in keep for w in fts["wav"].tolist()], dtype=bool)
        fts = fts.take((split == "test") | ((split == "train") & in_train))
    if keep_only_sd_m_fts:
        sel = [c for c in fts.columns if c.startswith(("m_", "sd_"))
               and not any(d in c for d in _DROPPED)]
        fts = Table({c: fts[c] for c in sel + NON_FEATURES})
    for c in fts.columns:
        col = fts[c]
        if col.dtype.kind == "f":
            fts[c] = np.where(np.isnan(col), 0.0, col)
        elif col.dtype == object:
            col = col.copy()
            col[[v != v for v in col.tolist()]] = 0
            fts[c] = col

    split = fts["split"]
    train, test = fts.take(split == "train"), fts.take(split == "test")
    names = [c for c in train.columns if c not in NON_FEATURES]
    x_train_full = _matrix(train, names)
    y_train = train["class"].astype(int)
    ms: dict = {}
    t0 = tick()
    mi = mutual_info(x_train_full, y_train, seed=seed, device=dev)
    selected = top_features(names, mi, kb_num)
    ms["MI"] = (tick() - t0) * 1e3
    probas: dict = {}

    x_tr, x_te = _matrix(train, selected), _matrix(test, selected)
    y_te_seg = test["class"].astype(int)
    rows = []
    for clf, _, abbrv in _make_classifiers(seed, device=dev):
        t0 = tick()
        clf.fit(x_tr, y_train)
        pred = clf.predict(x_te)
        proba = clf.predict_proba(x_te)
        ms[abbrv] = (tick() - t0) * 1e3
        probas[abbrv] = proba
        y_te = y_te_seg
        if majority_vote_prediction:
            _, (y_mean, p0, p1) = group_means(test["wav"], [y_te, proba[:, 0], proba[:, 1]])
            y_te = y_mean.astype(int)
            proba1 = p1
            pred = np.stack([p0, p1], axis=1).argmax(axis=1).astype(int)
        else:
            proba1 = proba[:, 1]
        rows.append({"Classifier": abbrv, **_scores(y_te, pred, proba1)})
    if record is not None:
        record.update(selected=selected, proba=probas, ms=ms)
    return Table.from_rows(rows)
