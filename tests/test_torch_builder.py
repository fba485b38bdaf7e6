"""The port's offline databuilder (``data/corpus.py``, ``data/builder.py``)
against ``pcgmix_tpu``'s on the same generated corpora: the fake
PhysioNet-2016 tree and the UMC tree of ``tests/test_corpus.py``, built
once per module.

Bars: keys, labels, frames, wavs, ``sig_qual``, ``id`` and ``excluded``
equal; the 1-D and "full" data bit-equal (host scipy on both sides); the
spectrograms within ``tests/test_torch_signal_ops.py``'s 1e-2 dB, which
the builds' standardization divides by the train statistics' std (13.9
at least), so 1e-2 / 13.9 in their units (the generic build's unscaled
spectrograms: 1e-2)."""

import csv
import os

import numpy as np
import pytest
import torch

from pcgmix_tpu import utils as jutils
from pcgmix_tpu.data import builder as jbuilder
from pcgmix_tpu.data import corpus as jcorpus
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.data import builder, corpus
from tests.test_corpus import build_fake_physionet_tree, umc_root  # noqa: F401 (fixture)
from tests.test_torch_signal_ops import DB_BAR

STD_MIN = min(jcorpus.PHYSIONET_SPEC_STATS[1], *(s for _, s in jcorpus.UMC_SPEC_STATS.values()))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def physionet_root(tmp_path_factory):
    return build_fake_physionet_tree(str(tmp_path_factory.mktemp("physionet")))


@pytest.fixture(scope="module")
def roots(physionet_root, umc_root):
    return {"physionet": physionet_root, "umc": umc_root}


def assert_same_build(got: dict, exp: dict, spec_bar: float) -> None:
    """Two built dataset dicts: the same keys and values, the 1-D bands bit
    for bit, a spectrogram array within ``spec_bar``."""
    assert sorted(got) == sorted(exp)
    if "train" in exp and "test" in exp:
        for split in exp:
            assert_same_build(got[split], exp[split], spec_bar)
        return
    for key, v in exp.items():
        if key == "data" and isinstance(v, dict):
            assert sorted(got[key]) == sorted(v)
            for band, a in v.items():
                assert got[key][band].dtype == a.dtype, band
                np.testing.assert_array_equal(got[key][band], a, err_msg=band)
        elif key == "data":
            assert got[key].shape == v.shape and got[key].dtype == v.dtype
            np.testing.assert_allclose(got[key], v, rtol=0, atol=spec_bar)
        else:
            assert got[key].dtype == v.dtype, key
            np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("kind", list(jcorpus.BUILDERS))
def test_corpus_build_matches_reference(kind, roots):
    root = roots["umc" if kind.startswith("umc") else "physionet"]
    exp = jcorpus.BUILDERS[kind](root)
    kw = {"device": "cpu"} if kind in corpus.SPECTROGRAM_KINDS else {}
    got = corpus.BUILDERS[kind](root, **kw)
    splits = [exp] if "label" in exp else [exp["train"], exp["test"]]
    assert all(len(s["label"]) for s in splits)
    assert_same_build(got, exp, DB_BAR / STD_MIN)


def test_corpus_cli_writes_a_dat_the_reference_reads(roots, tmp_path, capsys):
    """The CLI's ``physionet-spec128`` build restricted to a train list, on
    the CPU: JAX's ``file2dict`` reads the port's .dat and the port's reads
    JAX's, both equal to the reference build; the CLI prints its mel time."""
    lst = tmp_path / "train_list.txt"
    lst.write_text("a0000\nb0001\n")
    ours, theirs = str(tmp_path / "ours.dat"), str(tmp_path / "theirs.dat")
    args = ["--corpus", "physionet-spec128", "--root", roots["physionet"],
            "--train-wavs", str(lst)]
    builder.main([*args, "--out", ours, "--device", "cpu"])
    assert '"mel spectrogram"' in capsys.readouterr().out
    jbuilder.main([*args, "--out", theirs])
    got, exp = jutils.file2dict(ours), utils.file2dict(theirs)
    assert set(got["train"]["wav"]) == {"a0000", "b0001"}
    assert_same_build(got, exp, DB_BAR / STD_MIN)


def test_train_selection_matches_reference(roots):
    d = jcorpus.build_physionet_1d(roots["physionet"])
    assert corpus.physionet_train_selection(d) == jcorpus.physionet_train_selection(d)
    assert (corpus.physionet_train_selection(d, n_fraction=0.5, seed_data=3)
            == jcorpus.physionet_train_selection(d, n_fraction=0.5, seed_data=3))


def test_read_train_wavs_file_matches_reference(tmp_path):
    p = tmp_path / "lst.txt"
    p.write_text("a0001, a0002\n'b0003'\n\"b0004\",\n")
    assert corpus.read_train_wavs_file(str(p)) == jcorpus.read_train_wavs_file(str(p))


def _generic_tree(root: str, tmp_path) -> dict:
    """Generic-mode inputs from the PhysioNet tree: subset a's raw wavs at
    2 kHz, its hand-corrected StateAns .mat files, a labels csv."""
    rows = [r for r in jcorpus.read_subset_reference(root, "a") if r[2] == 1]
    labels = tmp_path / "labels.csv"
    with open(labels, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["wav", "label", "sig_qual"])
        w.writerows(rows)
    return {"--wav-dir": os.path.join(root, "training-a", "raw"),
            "--ann-dir": os.path.join(root, "annotations", "hand_corrected",
                                      "training-a_StateAns"),
            "--labels-csv": str(labels)}


@pytest.mark.parametrize("kind,normalize", [("1d", "physionet"), ("full", "none"),
                                            ("spec128", "physionet"), ("spec64", "none")])
def test_generic_build_matches_reference(kind, normalize, roots, tmp_path):
    flags = [x for kv in _generic_tree(roots["physionet"], tmp_path).items() for x in kv]
    args = [*flags, "--kind", kind, "--normalize", normalize]
    ours, theirs = str(tmp_path / "ours.dat"), str(tmp_path / "theirs.dat")
    builder.main([*args, "--out", ours, "--device", "cpu"])
    jbuilder.main([*args, "--out", theirs])
    got, exp = utils.file2dict(ours), jutils.file2dict(theirs)
    assert len(exp["label"])
    bar = DB_BAR / jcorpus.PHYSIONET_SPEC_STATS[1] if normalize == "physionet" else DB_BAR
    assert_same_build(got, exp, bar)


@pytest.mark.parametrize("args", [
    ["--corpus", "umc-1d"],  # no --root
    ["--corpus", "umc-1d", "--root", "r", "--kind", "1d"],  # a generic flag
    ["--corpus", "umc-1d", "--root", "r", "--normalize", "none"],
    ["--corpus", "umc-1d", "--root", "r", "--train-wavs", "l.txt"],  # spec128 only
    ["--wav-dir", "w", "--ann-dir", "a"],  # generic without --labels-csv
    ["--wav-dir", "w", "--ann-dir", "a", "--labels-csv", "l.csv"],  # no --normalize
    [],  # neither mode
], ids=["no-root", "generic-kind", "generic-normalize", "train-wavs", "no-labels",
        "no-normalize", "no-mode"])
def test_cli_usage_errors_match_reference(args, capsys):
    with pytest.raises(SystemExit) as ours:
        builder.main([*args, "--out", "x.dat", "--device", "cpu"])
    err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as theirs:
        jbuilder.main([*args, "--out", "x.dat"])
    assert ours.value.code == theirs.value.code == 2
    assert err == capsys.readouterr().err.strip().splitlines()[-1]


def test_build_on_cuda_without_a_card_raises(roots, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        builder.main(["--corpus", "umc-spec64", "--root", roots["umc"],
                      "--out", str(tmp_path / "x.dat")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corpus.build_umc_spec(roots["umc"], size=64)


@pytest.mark.parametrize("trace,match", [([1, 1, 2, 5, 3], "state codes must be 1..4"),
                                         ([4, 4, 1, 1, 2, 2, 3, 3, 4, 4, 1], None)])
def test_state_parsers_match_reference(trace, match, tmp_path):
    p = tmp_path / "t.txt"
    np.savetxt(p, np.asarray(trace), fmt="%d")
    if match:
        for fn in (builder.parse_umc_state_trace, jbuilder.parse_umc_state_trace):
            with pytest.raises(ValueError, match=match):
                fn(str(p))
        return
    got, exp = builder.parse_umc_state_trace(str(p)), jbuilder.parse_umc_state_trace(str(p))
    np.testing.assert_array_equal(got[0], exp[0])
    assert got[1] == exp[1]
    frames = np.array([0, 10, 30, 40, 70, 80, 100, 110, 140, 150])
    states = ["S1", "systole", "S2", "diastole"] * 2 + ["S1", "(N"]
    for a, b in zip(builder.parse_state_sequence(frames, states),
                    jbuilder.parse_state_sequence(frames, states)):
        np.testing.assert_array_equal(a, b)
