"""The runner's gang options (``pcgmix_tpu_torch/exp/runner.py``) on the
CPU: a ``--gang`` grid writes the run dirs, ``performance.pkl`` keys and
``model.pth`` of the sequential grid, a rerun skips them, the points a
gang cannot take train one by one, a (salopt…) grid trains its
dependencies as a gang before the hook gang, groups chunk at
``--gang-max-size``, and a failed gang falls back to sequential runs
unless ``--no-gang-fallback``."""

import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest
import torch

from pcgmix_tpu.exp import results as jresults
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.exp import runner
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.saliency import make_pretrained_saliency_fn
from pcgmix_tpu_torch.train import TrainConfig, train_model
from pcgmix_tpu_torch.train import gang

SEED_DATAS = ["1100001", "1100002", "1100003"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: a thread pool per process
    oversubscribes the CPU when the suite runs in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    ds = synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6,
                                  segments_per_wav=2, sig_len=512, seed=1)
    path = tmp_path_factory.mktemp("gang_grid") / "p.dat"
    utils.dict2file(ds, str(path))
    return str(path)


def _args(data_file, root, *extra, methods=("durmixmagwarp(0.2,4)",)):
    return ["--dataset-file", data_file, "--device", "cpu", "--model", "resnet9-5k",
            "--methods", *methods, "--num-epochs", "2", "--batch-size", "8",
            "--n-fractions", "0.5", "--seed-datas", *SEED_DATAS, "--no-robust",
            "--experiments-root", str(root), "--no-plot", *extra]


def _cfgs(root, method="durmixmagwarp(0.2,4)"):
    return [TrainConfig(model="resnet9-5k", method=method, num_epochs=2, batch_size=8,
                        n_fraction=0.5, seed_data=int(sd), experiments_root=str(root))
            for sd in SEED_DATAS]


def _perf(cfg):
    with open(os.path.join(experiment_dir(cfg), "performance.pkl"), "rb") as f:
        return pickle.load(f)


def test_gang_grid_writes_the_sequential_grids_run_dirs(data_file, tmp_path, capsys):
    seq, ganged = tmp_path / "seq", tmp_path / "gang"
    runner.main(_args(data_file, seq))
    runner.main(_args(data_file, ganged, "--gang", "--no-gang-fallback"))
    out = capsys.readouterr().out
    assert "gang of 3: durmixmagwarp(0.2,4) nfrac=0.5" in out
    assert out.count("done (gang): ") == 3 and "gang done: 3 members" in out
    assert sorted(os.listdir(seq)) == sorted(os.listdir(ganged))
    for a, b in zip(_cfgs(seq), _cfgs(ganged)):
        pa, pb = _perf(a), _perf(b)
        assert sorted(pa) == sorted(pb) and pa["steps"] == pb["steps"]
        assert abs(pa["train_loss"][0] - pb["train_loss"][0]) < 1e-5
        assert np.allclose(pa["train_loss"], pb["train_loss"], rtol=1e-3)
        sa = torch.load(os.path.join(experiment_dir(a), "model.pth"), weights_only=True)
        sb = torch.load(os.path.join(experiment_dir(b), "model.pth"), weights_only=True)
        assert sorted(sa) == sorted(sb)
        # the JAX package's results stack reads the gang's run dirs
        assert sorted(jresults.read_performance(b)) == sorted(pb)
    runner.main(_args(data_file, ganged, "--gang"))
    out = capsys.readouterr().out
    assert out.count("skip (done): ") == 3 and "gang of" not in out


def test_points_a_gang_cannot_take_run_one_by_one(data_file, tmp_path, capsys):
    """--latent-space points (their dumps read host batches) train through
    train_model one by one, in a --gang grid; lc-nointrusion, refused
    before the live mode was ported, gangs."""
    runner.main(_args(data_file, tmp_path / "dumps", "--gang", "--gang-max-size", "0",
                      "--latent-space", methods=("base",)))
    out = capsys.readouterr().out
    assert out.count("run: ") == 3 and "gang of" not in out
    for cfg in _cfgs(tmp_path / "dumps", "base"):
        assert os.path.exists(os.path.join(experiment_dir(cfg), "model.pth"))
    # members of equal train sizes gang; ragged ones (15 and 16 rows) have
    # no uniform '+p' gate in one live pass, so that gang falls back
    equal = ["--seed-datas", SEED_DATAS[0], SEED_DATAS[2]]
    runner.main(_args(data_file, tmp_path / "live", "--gang", "--no-gang-fallback",
                      *equal, methods=("lc-nointrusion",)))
    out = capsys.readouterr().out
    assert "gang of 2: lc-nointrusion" in out and out.count("done (gang): ") == 2
    assert "run: " not in out
    runner.main(_args(data_file, tmp_path / "ragged", "--gang", methods=("lc-nointrusion",)))
    out = capsys.readouterr().out
    assert "gang of 3 (lc-nointrusion) FAILED (ValueError: live-model methods" in out
    assert out.count("run: ") == 3
    for cfg in _cfgs(tmp_path / "ragged", "lc-nointrusion"):
        assert os.path.exists(os.path.join(experiment_dir(cfg), "model.pth"))


def test_salopt_grid_trains_its_dependency_gang_then_the_hook_gang(data_file, tmp_path,
                                                                  capsys):
    """A (saloptenv) grid with --gang trains its members' 'base' runs as a
    dependency gang, then the hook gang with one provider a member; the
    run dirs equal the sequential grid's (its dependencies run one by one)
    and a rerun skips every point."""
    methods = ("(saloptenv)durratiomixup",)
    seq, ganged = tmp_path / "seq", tmp_path / "gang"
    runner.main(_args(data_file, seq, methods=methods))
    assert capsys.readouterr().out.count("run (salopt dependency): ") == 3
    runner.main(_args(data_file, ganged, "--gang", "--no-gang-fallback", methods=methods))
    out = capsys.readouterr().out.splitlines()
    gangs = [ln for ln in out if ln.startswith("gang of ")]
    assert gangs == [f"gang of 3 (dependency): base seed_datas={[int(s) for s in SEED_DATAS]}",
                     f"gang of 3: (saloptenv)durratiomixup nfrac=0.5 seed_datas="
                     f"{[int(s) for s in SEED_DATAS]}"]
    assert sum(ln.startswith("done (gang): ") for ln in out) == 6
    assert not any(ln.startswith(("run: ", "run (")) for ln in out)
    assert sorted(os.listdir(seq)) == sorted(os.listdir(ganged))
    assert len(os.listdir(ganged)) == 6
    # each member planned with its own dependency's saliency model: its run
    # on that checkpoint alone (at lr 0.01 the ganged dependencies part from
    # the sequential ones, and with them the plans)
    for a, b in zip(_cfgs(seq, methods[0]), _cfgs(ganged, methods[0])):
        pa, pb = _perf(a), _perf(b)
        assert sorted(pa) == sorted(pb) and pa["steps"] == pb["steps"]
        cfg = dataclasses.replace(b, device="cpu", save_artifacts=False)
        alone = train_model(cfg, utils.file2dict(data_file), saliency_model_provider=(
            make_pretrained_saliency_fn(cfg, functools.partial(
                runner._salopt_checkpoint_dir, cfg, False))))
        assert abs(alone["train_loss"][0] - pb["train_loss"][0]) < 1e-5
        assert np.allclose(alone["train_loss"], pb["train_loss"], rtol=1e-3)
    runner.main(_args(data_file, ganged, "--gang", methods=methods))
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and all(ln.startswith("skip (done): ") for ln in out)


def test_gang_max_size_chunks_a_group(data_file, tmp_path, capsys):
    runner.main(_args(data_file, tmp_path, "--gang", "--gang-max-size", "2",
                      methods=("base",)))
    out = capsys.readouterr().out
    assert "gang of 2: base" in out and out.count("run: ") == 1


def test_gang_devices_that_do_not_divide_run_unsharded(data_file, tmp_path, capsys):
    runner.main(_args(data_file, tmp_path, "--gang", "--gang-devices", "2",
                      methods=("base",)))
    out = capsys.readouterr().out
    assert "gang of 3: base" in out
    assert "(size 3 not divisible by 2 devices — running unsharded)" in out


def test_a_failed_gang_falls_back_unless_told_not_to(data_file, tmp_path, capsys,
                                                     monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(gang, "train_gang", broken)
    with pytest.raises(RuntimeError, match="out of memory"):
        runner.main(_args(data_file, tmp_path / "strict", "--gang", "--no-gang-fallback",
                          methods=("base",)))
    runner.main(_args(data_file, tmp_path / "lenient", "--gang", methods=("base",)))
    out = capsys.readouterr().out
    assert "gang of 3 (base) FAILED (RuntimeError: out of memory)" in out
    assert out.count("run: ") == 3
    for cfg in _cfgs(tmp_path / "lenient", "base"):
        assert os.path.exists(os.path.join(experiment_dir(cfg), "model.pth"))


def test_auto_size_and_conv_impl_reach_the_gang(data_file, tmp_path, capsys, monkeypatch):
    seen = []
    train = gang.train_gang
    monkeypatch.setattr(gang, "train_gang",
                        lambda cfgs, *a, **k: seen.extend(cfgs) or train(cfgs, *a, **k))
    runner.main(_args(data_file, tmp_path, "--gang", "--conv-impl", "matmul",
                      methods=("base",)))
    out = capsys.readouterr().out
    assert "gang auto-size: S_max=" in out
    assert len(seen) == 3 and {c.conv_impl for c in seen} == {"matmul"}
