"""The port's classifier bench (``classical/selection.py``,
``classical/estimators.py``, ``run_experiment`` and the CLI's
``results.csv``) against scikit-learn 1.9.0 through the JAX package
(``pcgmix_tpu.classical.experiment``) on the same arrays and seeds.

Bars: mutual information within 1e-12, the selected features the same and
in the same order; Gaussian NB, k-NN, the decision tree, the forest and
gradient boosting within 1e-12 (their trees' nodes, features and
thresholds bit-equal); logistic regression, SGD and the SVC within 1e-6
(``BARS``); ``predict`` equal everywhere; ``run_experiment``'s rows the same
classifiers in the same order, each metric within its estimator's bar.
The fixtures are unscaled features of mixed scale, as the pipeline gives
them (logistic regression stops at 100 iterations unconverged there), with
a constant column, runs of equal values and a small-integer column.  The
references are fitted once per module; the largest differences measured
are printed."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

import pcgmix_tpu.classical as jclassical
from pcgmix_tpu import utils as jutils
from pcgmix_tpu.classical import __main__ as jcli
from pcgmix_tpu.classical import experiment as jexp
from pcgmix_tpu.data.synthetic import synthetic_physionet_dict
from pcgmix_tpu_torch.classical import __main__ as cli
from pcgmix_tpu_torch.classical import estimators as est
from pcgmix_tpu_torch.classical import experiment as exp
from pcgmix_tpu_torch.classical import features as pfeatures
from pcgmix_tpu_torch.classical.selection import mutual_info, top_features
from pcgmix_tpu_torch.classical.table import Table

# each estimator's bar on probabilities and metrics, in the bench's order
BARS = {"LR": 1e-6, "DT": 1e-12, "RF": 1e-12, "KN": 1e-12, "GNB": 1e-12, "SVC": 1e-6,
        "SGD": 1e-6, "GB": 1e-12}
SEEDS = (4, 7)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mixed_scale(seed: int, n: int, f: int, positive: float):
    """(n, f) features over 7 decades, shifted by class, unscaled; column 3
    constant, column 5 rounded (runs of equal values), column 7 small
    integers; 0/1 labels with ``positive`` of them 1."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < positive).astype(np.int64)
    scales = 10.0 ** rng.uniform(-3, 4, f)
    x = rng.standard_normal((n, f)) * scales + y[:, None] * rng.uniform(0, 1, f) * scales
    x[:, 3] = 0.25
    x[:, 5] = np.round(x[:, 5] / scales[5])
    x[:, 7] = rng.integers(0, 3, n)
    return x, y


def biggest(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both = np.isnan(a) & np.isnan(b)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.where(both, 0.0, np.abs(a - b)).max(initial=0.0))


# --------------------------------------------------------------------------- #
# the mutual-information selection
# --------------------------------------------------------------------------- #

# "tiny_class" has 10 rows of class 1, "brute_force_class" 5 (the
# reference's neighbour search by brute force, under 2k + 2 points)
MI_CASES = {"balanced": (4, 300, 60, 0.5), "minority": (7, 260, 50, 0.2),
            "tiny_class": (9, 120, 30, 0.08), "brute_force_class": (2, 60, 30, 0.08)}


@pytest.mark.parametrize("case", list(MI_CASES))
def test_mutual_info_matches_sklearn(case, capsys):
    from sklearn.feature_selection import mutual_info_classif

    seed, n, f, positive = MI_CASES[case]
    x, y = mixed_scale(seed, n, f, positive)
    want = mutual_info_classif(x, y, random_state=seed)
    got = mutual_info(x, y, seed=seed, device="cpu")
    diff = biggest(want, got)
    assert diff <= 1e-12
    names = [f"m_{i}" for i in range(f)]
    order = pd.DataFrame({"features": names, "MI": want}).sort_values("MI", ascending=False)
    for k in (5, 40):
        assert top_features(names, got, k) == list(order["features"].head(k).values)
    with capsys.disabled():
        print(f"\nMI {case}: largest difference {diff:.3e}")


def test_top_features_orders_ties_as_pandas():
    """Zeros and repeated scores (the clipped MI of uninformative
    features): pandas' unstable quicksort order, reproduced."""
    rng = np.random.default_rng(3)
    for n in (7, 40, 300):
        scores = np.where(rng.random(n) < 0.6, 0.0, rng.choice([0.1, 0.2, 0.05], n))
        names = [f"f{i}" for i in range(n)]
        order = pd.DataFrame({"features": names, "MI": scores}).sort_values("MI",
                                                                             ascending=False)
        for k in (1, 5, n):
            assert top_features(names, scores, k) == list(order["features"].head(k).values)


# --------------------------------------------------------------------------- #
# the estimators
# --------------------------------------------------------------------------- #

_fits: dict = {}


def fits(seed: int):
    """(test rows, reference estimators, port estimators), fitted once per
    seed on 400 mixed-scale rows of 40 features."""
    if seed not in _fits:
        x, y = mixed_scale(seed, 400, 40, 0.3)
        xt, _ = mixed_scale(seed + 100, 150, 40, 0.3)
        ref = {abbr: clf.fit(x, y) for clf, _, abbr in jexp._make_classifiers(seed)}
        port = {abbr: clf.fit(x, y) for clf, _, abbr in exp._make_classifiers(seed, "cpu")}
        _fits[seed] = (xt, ref, port)
    return _fits[seed]


def same_tree(ref, ours: est.Tree) -> bool:
    return (ref.node_count == ours.node_count
            and np.array_equal(ref.children_left, ours.children_left)
            and np.array_equal(ref.children_right, ours.children_right)
            and np.array_equal(ref.feature, ours.feature)
            and np.array_equal(ref.threshold.view(np.int64), ours.threshold.view(np.int64)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("abbr", list(BARS))
def test_estimator_matches_sklearn(abbr, seed, capsys):
    xt, ref, port = fits(seed)
    r, o = ref[abbr], port[abbr]
    diff = biggest(r.predict_proba(xt), o.predict_proba(xt))
    assert diff <= BARS[abbr]
    assert np.array_equal(r.predict(xt), o.predict(xt))
    if abbr == "DT":
        assert same_tree(r.tree_, o.tree_)
    elif abbr == "RF":
        assert all(same_tree(a.tree_, b) for a, b in zip(r.estimators_, o.estimators_))
    elif abbr == "GB":
        assert all(same_tree(a[0].tree_, b) for a, b in zip(r.estimators_, o.estimators_))
        values = np.array([a[0].tree_.value[:, 0, 0] for a in r.estimators_], dtype=object)
        assert all(np.array_equal(v, b.value[:, 0]) for v, b in zip(values, o.estimators_))
    elif abbr == "SVC":
        svc = r[-1]
        assert np.array_equal(svc.support_, o.support_)
        assert biggest(-svc.dual_coef_[0], o.dual_coef_) <= 1e-9
    elif abbr in ("LR", "SGD"):
        assert int(np.ravel(r.n_iter_)[0]) == o.n_iter_
    with capsys.disabled():
        print(f"\n{abbr} seed {seed}: largest probability difference {diff:.3e}")


def test_knn_needs_as_many_rows_as_neighbours():
    with pytest.raises(ValueError, match="neighbours"):
        est.KNeighborsClassifier(device="cpu").fit(np.zeros((4, 2)), np.array([0, 1, 0, 1]))


# --------------------------------------------------------------------------- #
# run_experiment and the CLI
# --------------------------------------------------------------------------- #


def group_case():
    """Values where a plain sum loses what Kahan's compensation keeps."""
    keys = np.array(["b", "a", "b", "a", "c", "b", "a"], dtype=object)
    vals = np.array([1e16, 1.0, 1.0, 1e-3, 5.0, -1e16, 3.0])
    return keys, vals


def test_group_means_as_pandas():
    keys, vals = group_case()
    want = pd.DataFrame({"k": keys, "v": vals, "w": vals[::-1]}).groupby("k", sort=False).mean()
    got_keys, (v, w) = exp.group_means(keys, [vals, vals[::-1]])
    assert got_keys == list(want.index)
    assert np.array_equal(v, want["v"].to_numpy()) and np.array_equal(w, want["w"].to_numpy())


@pytest.fixture(scope="module")
def dataset():
    """24 train and 10 test recordings of 6 segments at sig_len 600."""
    return synthetic_physionet_dict(num_wavs_train=24, num_wavs_test=10, segments_per_wav=6,
                                    sig_len=600, seed=11)


@pytest.fixture(scope="module")
def segment_rows(dataset):
    """The port's extraction (the CSV bytes of the JAX package's)."""
    return pfeatures.extract_features(dataset)


@pytest.fixture(scope="module")
def aggregated(segment_rows):
    """(the JAX package's aggregated frame, the port's aggregated table)."""
    df = jexp.aggregate_features_rolling(
        jexp.remove_segments_mean_envelope(pd.DataFrame(segment_rows)))
    table = exp.aggregate_features_rolling(
        exp.remove_segments_mean_envelope(Table.from_rows(segment_rows)))
    return df, table


def assert_results(want: pd.DataFrame, got: Table) -> dict:
    """The same classifiers in order and columns; each metric within the
    bar of its estimator.  Returns the largest difference a classifier."""
    assert got.columns == list(want.columns) == ["Classifier", *exp.METRICS]
    assert got["Classifier"].tolist() == list(want["Classifier"]) == list(BARS)
    worst = dict.fromkeys(BARS, 0.0)
    for c in exp.METRICS:
        for name, a, b in zip(got["Classifier"].tolist(), want[c].to_numpy(), got[c]):
            d = biggest([a], [b])
            assert d <= BARS[name], (c, name, a, b)
            worst[name] = max(worst[name], d)
    return worst


@pytest.mark.parametrize("majority", [True, False], ids=["majority", "segments"])
@pytest.mark.parametrize("subset", [False, True], ids=["all_train", "train_wavs"])
def test_run_experiment_matches_jax(aggregated, subset, majority, capsys):
    df, table = aggregated
    train = sorted(set(df.loc[df["split"] == "train", "wav"]))
    kw = dict(train_wavs=train[: len(train) // 2] if subset else None,
              majority_vote_prediction=majority,
              kb_num=40, seed=4)
    want = jclassical.run_experiment(df, **kw)
    got = exp.run_experiment(table, device="cpu", **kw)
    worst = assert_results(want, got)
    with capsys.disabled():
        print(f"\nrun_experiment train_wavs={subset} majority={majority}: largest metric "
              f"difference {max(worst.values()):.3e}")


def test_run_experiment_all_columns_and_nan(capsys):
    """``keep_only_sd_m_fts=False`` (every non-label column, the excluded
    names included) and NaN features filled with 0, on a mixed-scale table
    of recordings with 1 to 6 rows."""
    rng = np.random.default_rng(5)
    names = [f"m_f{i}" if i % 2 else f"sd_f{i}" for i in range(30)]
    names[2], names[4], names[6] = "m_MaxAmp_x", "sd_chroma1", "other"
    scales = 10.0 ** rng.uniform(-4, 4, len(names))
    rows = []
    for r in range(50):
        c, split = int(rng.random() < 0.4), "train" if r < 35 else "test"
        for s in range(int(rng.integers(1, 7))):
            v = rng.standard_normal(len(names)) * scales + c * 0.4 * scales
            row = {"class": c, "wav": f"r{r:03d}", "segment": s, "sig_qual": 1,
                   "split": split, **dict(zip(names, v.tolist()))}
            if rng.random() < 0.1:
                row[names[9]] = float("nan")
            rows.append(row)
    for kw in (dict(keep_only_sd_m_fts=False, kb_num=7), dict(kb_num=40)):
        want = jclassical.run_experiment(pd.DataFrame(rows), seed=7, **kw)
        got = exp.run_experiment(Table.from_rows(rows), seed=7, device="cpu", **kw)
        worst = assert_results(want, got)
        with capsys.disabled():
            print(f"\nrun_experiment {kw}: largest metric difference {max(worst.values()):.3e}")


def test_run_experiment_needs_the_card_unless_cpu(aggregated):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.run_experiment(aggregated[1], kb_num=5)


def test_cli_results_match_jax_cli(dataset, segment_rows, monkeypatch, tmp_path, capsys):
    """Both CLIs on one .dat with ``--kb-num 5 --train-wavs`` (the first
    half of the train recordings, both classes) and the rolling window: the port's results.csv holds
    the JAX CLI's columns and rows within the bars.  Both extractions are
    served from the module's rows."""
    dat = tmp_path / "d.dat"
    jutils.dict2file(dataset, str(dat))
    wavs = tmp_path / "train_wavs.txt"
    train = sorted(set(dataset["train"]["wav"]))
    wavs.write_text("\n".join(train[: len(train) // 2]) + "\n")
    monkeypatch.setattr(jclassical, "extract_features",
                        lambda *a, **k: pd.DataFrame(segment_rows))
    monkeypatch.setattr(pfeatures, "extract_features", lambda *a, **k: list(segment_rows))

    def args(side):
        return ["--dataset-file", str(dat), "--out-dir", str(tmp_path / side), "--kb-num", "5",
                "--train-wavs", str(wavs)]

    assert jcli.main(args("jax")) == 0
    assert cli.main(args("port") + ["--device", "cpu"]) == 0
    for name in ("features.csv", "aggregated.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    want = pd.read_csv(tmp_path / "jax" / "results.csv", float_precision="round_trip")
    worst = assert_results(want, Table.read_csv(str(tmp_path / "port" / "results.csv")))
    assert sorted(os.listdir(tmp_path / "port")) == ["aggregated.csv", "features.csv",
                                                     "results.csv"]
    with capsys.disabled():
        print(f"\nCLI results.csv: largest metric difference {max(worst.values()):.3e}")
