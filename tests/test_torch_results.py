"""The port's results tables, paper tables, CSV export and replication
report against pcgmix_tpu.exp and scripts/replicate_synthetic.py on the
committed mini run-dir fixture (artifacts/replication_runs_mini, 12
finished runs of the JAX package), and the effect corpus bit-equal to the
JAX generator."""

import copy
import importlib.util
import json
import os

import numpy as np
import pytest

from pcgmix_tpu.data import synthetic_effect_dict as jsynthetic_effect_dict
from pcgmix_tpu.exp import paper as jpaper
from pcgmix_tpu.exp import results as jresults
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu_torch.data import synthetic_effect_dict
from pcgmix_tpu_torch.exp import paper, replicate, results
from pcgmix_tpu_torch.train import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "artifacts", "replication_runs_mini")
METHODS = ["base", "durratiomixup+1.0", "durmixmagwarp(0.2,4)+1.0"]
LABELS = ["Vanilla", "PCGmix", "PCGmix+"]
N_FRACS = [0.1, 1.0]


def _cfgs(model="resnet9-5k"):
    common = dict(dataset="PhysioNet", model=model, num_epochs=12, batch_size=8,
                  experiments_root=FIXTURE)
    return TrainConfig(**common), JTrainConfig(**common)


def _records(df):
    return df.to_dict("records")


@pytest.mark.parametrize("metric", ["Accuracy", "ROC AUC", "F1 score"])
def test_results_table_equals_reference(metric):
    cfg, jcfg = _cfgs()
    got = results.results_table(cfg, METHODS, N_FRACS + [0.4], metric, robust=False)
    exp = jresults.results_table(jcfg, METHODS, N_FRACS + [0.4], metric, robust=False)
    assert got == _records(exp)
    g = results.read_experiments_all_dataseeds(cfg, N_FRACS, metric, robust=False)
    e = jresults.read_experiments_all_dataseeds(jcfg, N_FRACS, metric, robust=False)
    assert vars(g) == vars(e)


def test_paper_table_and_grids_equal_reference():
    cfg, jcfg = _cfgs()
    mean, std = paper.method_grid(cfg, METHODS, N_FRACS, robust=False)
    jmean, jstd = jpaper.method_grid(jcfg, METHODS, N_FRACS, robust=False)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    got = paper.paper_table({"resnet9-5k": cfg, "other": cfg}, METHODS, N_FRACS,
                            robust=False, method_labels=LABELS)
    exp = jpaper.paper_table({"resnet9-5k": jcfg, "other": jcfg}, METHODS, N_FRACS,
                             robust=False, method_labels=LABELS)
    assert got == _records(exp)
    md = results.to_markdown(got)
    assert md.splitlines()[0].split("|")[1].strip() == "N frac"
    assert len(md.splitlines()) == 2 + len(got)


def test_relative_improvement_equals_reference(rng):
    mean = rng.uniform(50, 100, (4, 5))
    std = rng.uniform(0, 5, (4, 5))
    mean[2, 3] = np.nan
    std[0, 1] = np.nan
    for got, exp in zip(paper.relative_improvement_over_vanilla(mean, std),
                        jpaper.relative_improvement_over_vanilla(mean, std)):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(paper.propagate_error(3.0, 0.2, 2.0, 0.1),
                                  jpaper.propagate_error(3.0, 0.2, 2.0, 0.1))


def test_export_all_seeds_csvs_equals_reference(tmp_path):
    cfg, jcfg = _cfgs()
    fracs = N_FRACS + [0.4]  # a column without runs: empty cells
    got = paper.export_all_seeds_csvs(cfg, METHODS, fracs, out_dir=str(tmp_path / "t"),
                                      robust=False, method_labels=LABELS)
    exp = jpaper.export_all_seeds_csvs(jcfg, METHODS, fracs, out_dir=str(tmp_path / "j"),
                                       robust=False, method_labels=LABELS)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in exp]
    for g, e in zip(got, exp):
        assert open(g).read() == open(e).read()


def _load_script():
    path = os.path.join(REPO, "scripts", "replicate_synthetic.py")
    spec = importlib.util.spec_from_file_location("replicate_synthetic", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_replicate_mini_equals_the_jax_script(tmp_path):
    """On the finished fixture every run is skipped; the report's numbers,
    keys and exit code equal the JAX script's."""
    ours, theirs = str(tmp_path / "torch.md"), str(tmp_path / "jax.md")
    rc = replicate.main(["--mini", "--device", "cpu", "--experiments-root", FIXTURE,
                         "--out", ours])
    jrc = _load_script().main(["--mini", "--experiments-root", FIXTURE, "--out", theirs])
    assert rc == jrc
    got = json.load(open(ours.replace(".md", ".json")))
    exp = json.load(open(theirs.replace(".md", ".json")))
    assert sorted(got) == sorted(exp)
    assert got == exp
    md = open(ours).read()
    for label in ("Vanilla (no aug.)", "PCGmix (ours)", "PCGmix+ (ours)", "paired t"):
        assert label in md


def test_synthetic_effect_dict_equals_reference():
    kw = dict(num_wavs_train=6, num_wavs_test=4, segments_per_wav=2, sig_len=640,
              seed=7, murmur_amp=0.55, confounder_amp=1.2)
    got, exp = synthetic_effect_dict(**kw), jsynthetic_effect_dict(**kw)
    for split in ("train", "test"):
        assert sorted(got[split]) == sorted(exp[split])
        for band in exp[split]["data"]:
            g, e = got[split]["data"][band], exp[split]["data"][band]
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)
        for key in ("label", "frames", "wav", "sig_qual"):
            np.testing.assert_array_equal(got[split][key], exp[split][key])


def test_results_cli_paper_and_export(tmp_path, capsys):
    args = ["--experiments-root", FIXTURE, "--model", "resnet9-5k", "--methods", *METHODS,
            "--n-fractions", *map(str, N_FRACS), "--num-epochs", "12", "--batch-size", "8",
            "--no-robust", "--paper", "--method-labels", *LABELS,
            "--export-csv", str(tmp_path)]
    assert results.main(args) == 0
    out = capsys.readouterr().out
    assert "PCGmix+ (ours)" in out and "resnet9-5k ri" in out
    assert len(os.listdir(tmp_path)) == 2
    cfg, _ = _cfgs()
    run = copy.deepcopy(cfg)
    run.method = METHODS[0]
    assert results.read_experiments_all_dataseeds(run, [1.0], robust=False).num_runs == [2]
