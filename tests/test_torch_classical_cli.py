"""The port's classical pipeline (``classical/table.py``,
``classical/experiment.py``, ``classical/__main__.py``) against
``pcgmix_tpu.classical`` on the same inputs.

Bars: the table reads and writes what pandas reads and writes (dtypes,
NaN fields, int→float promotion, bool), byte for byte; pruning and both
aggregations bit-equal (NaN where NaN); the subset files, the collectors'
snapshots and the fresh CLI's ``features.csv``/``aggregated.csv``
byte-equal.  A resume re-reads a checkpoint: the port reads floats
exactly, pandas' default parser keeps about 16 significant digits (a field
written as 0.00020804254454999697 reads back 3,578 ulp away).  So the
port's own resume must equal its fresh run byte for byte, and the JAX
CLI's resumed ``features.csv`` must equal the port's with the checkpoint
rows as pandas' parser reads them, and its ``aggregated.csv`` the port's
aggregation of that ``features.csv``; how far the two CLIs' resumed
tables part is printed.  The fresh run's ``results.csv`` (the port's own
classifier bench) holds the JAX CLI's columns and classifiers, each
metric within its estimator's bar (``tests/test_torch_classical_bench.py``).
The JAX package's extraction runs once per module (about 0.25 s a
segment); its CLI gets that result through a stand-in of
``extract_features`` that honours ``start_counter`` and ``save_path`` as
the function does, and its sklearn bench runs in the fresh run and is
stubbed in the resumes."""

import io
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
from pcgmix_tpu_torch.classical import experiment as exp
from pcgmix_tpu_torch.classical.features import extract_features, write_csv
from pcgmix_tpu_torch.classical.table import Table, concat


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same(df: pd.DataFrame, table: Table) -> None:
    """The same columns in order, dtypes and values; floats bit for bit."""
    assert list(df.columns) == table.columns
    for c in df.columns:
        a, b = df[c].to_numpy(), table[c]
        if a.dtype.kind in "fib":
            assert a.dtype == b.dtype, c
            if a.dtype.kind == "f":
                same = (a.view(np.int64) == b.view(np.int64)) | (np.isnan(a) & np.isnan(b))
                assert same.all(), (c, a[~same][:3], b[~same][:3])
            else:
                assert np.array_equal(a, b), c
        else:
            assert [None if v != v else v for v in a.tolist()] == \
                   [None if v != v else v for v in b.tolist()], c


def same_csv(df: pd.DataFrame, table: Table, tmp_path) -> bool:
    df.to_csv(tmp_path / "pandas.csv", index=False)
    table.to_csv(str(tmp_path / "port.csv"))
    return (tmp_path / "pandas.csv").read_bytes() == (tmp_path / "port.csv").read_bytes()


# --------------------------------------------------------------------------- #
# the table
# --------------------------------------------------------------------------- #

CSV_CASES = {
    "ints_floats_strings": "a,b,c\n1,0.1,x\n2,1e-05,y\n",
    "empty_field_promotes": "a,d,e\n1,,\n2,3,\n",
    "bools": "f,g\nTrue,1\nFalse,2\n",
    "bools_with_empty": "f,g\nTrue,1\n,2\n",
    "seventeen_digits": ("x\n0.30000000000000004\n-1.2345678901234567e-05\n"
                         "1.7976931348623157e+308\n"),
    "negative_zero_inf": "x,y\n-0.0,inf\n5e-324,-inf\n",
    "quoted": 'w,v\n"a,b",1\nplain,2\n',
}


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_table_reads_and_writes_as_pandas(case, tmp_path):
    path = tmp_path / "in.csv"
    path.write_text(CSV_CASES[case])
    df = pd.read_csv(path, float_precision="round_trip")
    table = Table.read_csv(str(path))
    assert_same(df, table)
    assert same_csv(df, table, tmp_path)


def test_table_from_rows_and_concat_as_pandas(tmp_path):
    """``pd.DataFrame(rows)`` and ``pd.concat``: columns in order of first
    appearance, NaN where a table lacks a column, int → float64 where a
    NaN lands, bool → object, strings with NaN."""
    rows_a = [{"class": 1, "wav": "a", "n": 3, "x": 0.5, "flag": True},
              {"class": 0, "wav": "b", "n": 4, "x": float("nan"), "flag": False}]
    rows_b = [{"class": 1, "wav": "c", "x": 2.0, "extra": "e", "m": 7}]
    a, b = pd.DataFrame(rows_a), pd.DataFrame(rows_b)
    ta, tb = Table.from_rows(rows_a), Table.from_rows(rows_b)
    assert_same(a, ta)
    both = pd.concat([a, b], ignore_index=True)
    tboth = concat([ta, tb])
    assert tboth["n"].dtype == np.float64 and tboth["class"].dtype == np.int64
    assert same_csv(both, tboth, tmp_path)
    assert_same(both.drop(columns=["flag", "extra"]), tboth.drop(["flag", "extra"]))


def test_table_sorts_as_pandas():
    """A multi-key sort is stable (ties keep concat order); a one-key sort
    is numpy's quicksort of the key, as ``nargsort``."""
    rng = np.random.default_rng(0)
    rec = rng.choice(["r2", "r10", "r1", "a"], 60)
    seg = rng.choice([0, 1, 999], 60)
    df = pd.DataFrame({"recording": rec, "segment": seg, "i": np.arange(60)})
    t = Table({"recording": rec.astype(object), "segment": seg, "i": np.arange(60)})
    assert np.array_equal(df.sort_values(by=["recording", "segment"])["i"].to_numpy(),
                          t.sort_values(["recording", "segment"])["i"])
    assert np.array_equal(df.sort_values(by="segment")["i"].to_numpy(),
                          t.sort_values("segment")["i"])


# --------------------------------------------------------------------------- #
# pruning and aggregation
# --------------------------------------------------------------------------- #


def _feature_rows(seed: int = 1) -> list[dict]:
    """Recordings of 1–40 segments (shuffled), with a mixed-scale column
    (values over 18 decades), a constant column, an all-NaN column, ±inf,
    an int feature, a negative column and runs of equal values."""
    rng = np.random.default_rng(seed)
    rows = []
    for r, n in enumerate([1, 2, 5, 20, 40, 3, 9, 17]):
        for s in rng.permutation(n):
            rows.append({
                "class": r % 2, "wav": f"w{r:03d}", "segment": int(s), "sig_qual": 1,
                "split": "train" if r < 5 else "test",
                "MeanEnv_RR": float(rng.normal(1, 0.3)),
                "mixed": float(rng.standard_normal() * 10.0 ** rng.integers(-9, 9)),
                "const": 0.1, "allnan": float("nan"),
                "someinf": float(rng.choice([np.inf, -np.inf, np.nan, rng.normal()])),
                "ints": int(rng.integers(0, 5)), "neg": -abs(float(rng.normal())),
                "rep": float(rng.choice([1.0, 1.0, 0.1])),
            })
    return rows


AGGREGATIONS = {
    "prune_1.4": (lambda m, t: m.remove_segments_mean_envelope(t, std_factor=1.4)),
    "prune_0.5": (lambda m, t: m.remove_segments_mean_envelope(t, std_factor=0.5)),
    "rolling_2": (lambda m, t: m.aggregate_features_rolling(t, window=2)),
    "rolling_3": (lambda m, t: m.aggregate_features_rolling(t, window=3)),
    "rolling_1": (lambda m, t: m.aggregate_features_rolling(t, window=1)),
    "single": (lambda m, t: m.aggregate_features_single(t)),
}


@pytest.mark.parametrize("name", list(AGGREGATIONS))
def test_aggregations_bit_equal(name, tmp_path):
    rows = _feature_rows()
    fn = AGGREGATIONS[name]
    want = fn(jexp, pd.DataFrame(rows))
    got = fn(exp, Table.from_rows(rows))
    assert_same(want, got)
    assert same_csv(want, got, tmp_path)


def test_rolling_constant_window_is_zero():
    """pandas' rule for a run of equal values: a constant window's SD is
    exactly 0 (``[nan, 0, 0, 0.636…, 0, 0]`` for ``[1,1,1,.1,.1,.1]``)."""
    values = np.array([[1.0], [1.0], [1.0], [0.1], [0.1], [0.1]])
    sd = np.sqrt(exp.roll_var(values, 2))[:, 0]
    want = pd.Series(values[:, 0]).rolling(2).std().to_numpy()
    assert np.isnan(sd[0]) and list(sd[1:]) == list(want[1:])
    assert sd[1] == sd[2] == sd[4] == sd[5] == 0.0


@pytest.mark.parametrize("window", [2, 3, 6])
def test_rolling_long_mixed_scale_series(window):
    """The online mean and variance over 2,000 mixed-scale rows (values
    over 12 decades, NaN among them), each column on its own, against
    pandas: the window that pandas starts afresh after a cancelling
    removal included."""
    rng = np.random.default_rng(window)
    x = rng.standard_normal((2000, 3)) * 10.0 ** rng.integers(-6, 6, (2000, 3))
    x[rng.random((2000, 3)) < 0.02] = np.nan
    df = pd.DataFrame(x).rolling(window)
    for got, want in ((exp.roll_mean(x, window), df.mean().to_numpy()),
                      (exp.roll_var(x, window), df.var().to_numpy())):
        same = (got.view(np.int64) == want.view(np.int64)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), np.argwhere(~same)[:3]


# --------------------------------------------------------------------------- #
# extracted features, the subset files and the collectors
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def dataset():
    """Five train and two test recordings of 4, 2 or 1 segments at
    sig_len 600; one cycle's systole too short for some PSD bands (NaN
    features)."""
    d = synthetic_physionet_dict(num_wavs_train=5, num_wavs_test=2, segments_per_wav=2,
                                 sig_len=600, seed=3)
    d["train"]["frames"][2] = [0, 20, 45, 70, 300]
    d["train"]["wav"][2:4] = [d["train"]["wav"][1]] * 2  # a 4-segment recording
    d["test"]["wav"][1] = "lone"  # a 1-segment recording
    return d


@pytest.fixture(scope="module")
def jax_features(dataset):
    """The JAX package's extraction of every segment, once."""
    return jclassical.extract_features(dataset)


@pytest.fixture(scope="module")
def dat(dataset, tmp_path_factory):
    path = tmp_path_factory.mktemp("dat") / "d.dat"
    jutils.dict2file(dataset, str(path))
    return str(path)


def test_extracted_table_and_aggregations(dataset, jax_features, tmp_path):
    table = Table.from_rows(extract_features(dataset))
    assert same_csv(jax_features, table, tmp_path)
    for name in ("prune_1.4", "rolling_2", "single"):
        fn = AGGREGATIONS[name]
        want, got = fn(jexp, jax_features), fn(exp, table)
        assert_same(want, got)
        assert same_csv(want, got, tmp_path), name


def test_export_nfrac_wav_subsets_byte_equal(dataset, tmp_path):
    grids = {0.5: [7, 8]}
    want = jexp.export_nfrac_wav_subsets(dataset, str(tmp_path / "jax"), [0.5, 1.0],
                                         seed_datas_by_nfrac=grids)
    got = exp.export_nfrac_wav_subsets(dataset, str(tmp_path / "port"), [0.5, 1.0],
                                       seed_datas_by_nfrac=grids)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(want, got):
        assert open(a, "rb").read() == open(b, "rb").read(), b
    assert exp.export_nfrac_wav_subsets(dataset, str(tmp_path / "port"), [0.5, 1.0],
                                        seed_datas_by_nfrac=grids) == []


def _merged(run_dir, base_df, base_table, tmp_path, steps_per_epoch=2):
    """The collectors of both packages on one run dir: the concatenated
    dumps and the snapshots (pandas reads the dumps with its exact parser
    on the JAX side; its default one is an ulp off for some fields)."""
    read = pd.read_csv
    exact = lambda path, **kw: read(path, float_precision="round_trip", **kw)  # noqa: E731
    mp = pytest.MonkeyPatch()
    mp.setattr(jexp.pd, "read_csv", exact)
    try:
        want_all = jexp.collect_augmentation_features(run_dir)
        want = jexp.merge_augmentation_features(run_dir, base_df, str(tmp_path / "jax"),
                                                "t", steps_per_epoch=steps_per_epoch)
    finally:
        mp.undo()
    got_all = exp.collect_augmentation_features(run_dir)
    got = exp.merge_augmentation_features(run_dir, base_table, str(tmp_path / "port"),
                                          "t", steps_per_epoch=steps_per_epoch)
    assert same_csv(want_all, got_all, tmp_path)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(want, got):
        assert open(a, "rb").read() == open(b, "rb").read(), b
    return got


def test_collectors_on_the_reference_fixture(tmp_path):
    """``tests/test_classical.py``'s collector fixture: four dumps, a stray
    file, a two-row base; snapshots byte-equal, the base left as it was."""
    cs = tmp_path / "classical_space"
    cs.mkdir()
    for i in range(4):
        pd.DataFrame({
            "class": [0, 1], "wav": [f"r{i}a", f"r{i}b"], "segment": [0, 1],
            "sig_qual": [1, 1], "split": ["train"] * 2, "m_f1": [0.1 * i, 0.2 * i],
        }).to_csv(cs / f"train_{i}.csv", index=False)
    (cs / "notes.txt").write_text("junk")
    base = {"class": [0, 1], "recording": ["x_filtBandIIR(ZP)4-25-400_normRMS"] * 2,
            "segment": [0, 1], "m_f1": [0.5, 0.6]}
    base_table = Table({"class": np.array([0, 1]),
                        "recording": np.array(base["recording"], dtype=object),
                        "segment": np.array([0, 1]), "m_f1": np.array([0.5, 0.6])})
    paths = _merged(str(tmp_path), pd.DataFrame(base), base_table, tmp_path)
    assert [p.rsplit("part=", 1)[1] for p in paths] == ["0.csv", "1.csv", "2.csv"]
    assert list(base_table["class"]) == [0, 1]


def test_collectors_on_extracted_rows(dataset, tmp_path):
    """A base table of extracted rows (recording names as the UMC notebook
    writes them) and three dumps of extracted rows (17-digit features,
    NaN fields) in a run dir, one snapshot per step: segment-999 rows of
    one recording tie and keep their concat order."""
    rows = extract_features(dataset)
    cs = tmp_path / "run" / "classical_space"
    cs.mkdir(parents=True)
    for i in range(3):
        write_csv(rows[i * 4:i * 4 + 6], str(cs / f"train_{i}.csv"))
    base_rows = [{**{k: v for k, v in r.items() if k not in ("sig_qual", "split", "wav")},
                  "recording": f"{r['wav']}_filtBandIIR(ZP)4-25-400_normRMS"}
                 for r in rows[8:]]
    paths = _merged(str(tmp_path / "run"), pd.DataFrame(base_rows),
                    Table.from_rows(base_rows), tmp_path, steps_per_epoch=1)
    assert len(paths) == 4
    assert len(Table.read_csv(paths[-1])) == len(base_rows) + 18


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #


@pytest.fixture
def jax_cli(monkeypatch, jax_features):
    """The JAX CLI with its extraction served from the module's one run:
    rows from ``start_counter`` on, written to ``save_path`` as the
    function writes them.  ``bench=False`` stubs the sklearn bench."""
    def extract(dataset, splits=("train", "test"), band="25-400", start_counter=0,
                skip=(), save_path=None):
        assert tuple(splits) == ("train", "test") and band == "25-400" and not skip
        df = jax_features.iloc[max(start_counter - 1, 0):].reset_index(drop=True)
        if save_path:
            df.to_csv(save_path, index=False)
        return df

    monkeypatch.setattr(jclassical, "extract_features", extract)

    def run(argv, bench=True):
        if not bench:
            monkeypatch.setattr(jclassical, "run_experiment",
                                lambda agg, **kw: pd.DataFrame({"Classifier": []}))
        return jcli.main(argv)

    return run


def _args(dat, out):
    return ["--dataset-file", dat, "--out-dir", str(out), "--kb-num", "5"]


def test_cli_fresh_run_byte_equal_and_hands_off(dat, jax_cli, tmp_path, capsys):
    """A fresh run writes the JAX CLI's features.csv and aggregated.csv and
    benches them itself, handing nothing off: its results.csv holds the
    JAX CLI's columns and eight classifiers in order, each metric within its
    estimator's bar, and the table is printed; no JAX command is."""
    from tests.test_torch_classical_bench import BARS

    assert jax_cli(_args(dat, tmp_path / "jax")) == 0
    capsys.readouterr()
    assert cli.main(_args(dat, tmp_path / "port") + ["--device", "cpu"]) == 0
    for name in ("features.csv", "aggregated.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    out, err = capsys.readouterr()
    assert "pcgmix_tpu.classical" not in out + err
    want = pd.read_csv(tmp_path / "jax" / "results.csv", float_precision="round_trip")
    got = Table.read_csv(str(tmp_path / "port" / "results.csv"))
    assert got.columns == list(want.columns)
    assert got["Classifier"].tolist() == list(want["Classifier"]) == list(BARS)
    for c in got.columns[1:]:
        a, b = want[c].to_numpy(), got[c]
        assert np.array_equal(np.isnan(a), np.isnan(b)), c
        for name, x, y in zip(got["Classifier"].tolist(), a, b):
            assert x != x or abs(x - y) <= BARS[name], (c, name, x, y)
    assert all(name in out for name in BARS)


def _ulps(a: Table, b: Table) -> tuple[int, int]:
    """(fields that differ, the largest difference in ulps) of two tables
    with the same columns and dtypes."""
    assert a.columns == b.columns and len(a) == len(b)
    n, worst = 0, 0
    for c in a.columns:
        x, y = a[c], b[c]
        assert x.dtype == y.dtype, c
        if x.dtype.kind != "f":
            assert [v if v == v else None for v in x.tolist()] == \
                   [v if v == v else None for v in y.tolist()], c
            continue
        nan = np.isnan(x)
        assert np.array_equal(nan, np.isnan(y)), c
        d = np.abs(x[~nan].view(np.int64) - y[~nan].view(np.int64))
        n += int((d > 0).sum())
        worst = max(worst, int(d.max(initial=0)))
    return n, worst


def test_cli_resume_protocol(dat, jax_cli, jax_features, tmp_path, capsys):
    """Both CLIs through one crash story: a checkpoint of 8 segments is
    refused without --start-counter; a resume from counter 7 re-extracts
    the overlap and writes features.partial.prev.csv; a second crash
    leaves segments 7–12 in the checkpoint; a third run from counter 13
    folds both in; the checkpoints are removed at the end."""
    fresh = tmp_path / "fresh"
    assert cli.main(_args(dat, fresh) + ["--device", "cpu"]) == 0
    header, *lines = (fresh / "features.csv").read_text().splitlines(keepends=True)
    tables = {}
    for side in ("port", "jax"):
        out = tmp_path / side
        out.mkdir()
        (out / "features.partial.csv").write_text("".join([header] + lines[:8]))
        main = ((lambda a: cli.main(a + ["--device", "cpu"])) if side == "port"
                else (lambda a: jax_cli(a, bench=False)))
        with pytest.raises(SystemExit, match="partial extraction \\(8 segments\\)"):
            main(_args(dat, out))
        # the first resume, cut short after it checkpointed segments 7-12
        assert main(_args(dat, out) + ["--start-counter", "7"]) == 0
        assert not (out / "features.partial.csv").exists()
        assert not (out / "features.partial.prev.csv").exists()
        os.remove(out / "features.csv")
        (out / "features.partial.prev.csv").write_text("".join([header] + lines[:8]))
        (out / "features.partial.csv").write_text("".join([header] + lines[6:12]))
        assert main(_args(dat, out) + ["--start-counter", "13"]) == 0
        assert sorted(os.listdir(out)) == ["aggregated.csv", "features.csv", "results.csv"]
        tables[side] = {n: Table.read_csv(str(out / n))
                        for n in ("features.csv", "aggregated.csv")}
    for name in ("features.csv", "aggregated.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (fresh / name).read_bytes()
    n, worst = _ulps(tables["port"]["features.csv"], tables["jax"]["features.csv"])
    agg_n, agg_worst = _ulps(tables["port"]["aggregated.csv"], tables["jax"]["aggregated.csv"])
    with capsys.disabled():
        print(f"\nresumed features.csv: {n} fields differ from the JAX CLI's, by at most "
              f"{worst} ulp; aggregated.csv: {agg_n} fields, by at most {agg_worst} ulp")
    # the JAX CLI's resume is the port's with its checkpoint rows (the first
    # 12) as pandas' default parser reads them
    parsed = pd.read_csv(io.StringIO("".join([header] + lines[:12])))
    rest = pd.read_csv(fresh / "features.csv", float_precision="round_trip").iloc[12:]
    pd.concat([parsed, rest], ignore_index=True).to_csv(tmp_path / "want.csv", index=False)
    assert (tmp_path / "want.csv").read_bytes() == (tmp_path / "jax" / "features.csv").read_bytes()
    assert len(tables["port"]["features.csv"]) == len(jax_features)
    # and its aggregates are the port's of those features
    ours = exp.aggregate_features_rolling(
        exp.remove_segments_mean_envelope(tables["jax"]["features.csv"]))
    ours.to_csv(str(tmp_path / "ours.csv"))
    want = (tmp_path / "jax" / "aggregated.csv").read_bytes()
    assert (tmp_path / "ours.csv").read_bytes() == want
