"""The port's grid runner and robust schedules against pcgmix_tpu.exp:
``hyperparameters_robust`` equal to the JAX one for every published
(method, n_fraction) × model, the same run-directory names, run dirs that
the JAX package's ``read_performance`` reads back, resume-skip on a rerun,
the dependency methods over two data-parallel ranks, and the options that
wait for later slices refused."""

import copy
import dataclasses
import os

import numpy as np
import pytest

from pcgmix_tpu.exp import results as jresults
from pcgmix_tpu.exp.dirs import experiment_dir as jexperiment_dir
from pcgmix_tpu.exp.robust import _CP_TABLE as J_CP_TABLE
from pcgmix_tpu.exp.robust import N_FRACTIONS as J_N_FRACTIONS
from pcgmix_tpu.exp.robust import hyperparameters_robust as jrobust
from pcgmix_tpu.train import TrainConfig as JTrainConfig
from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.exp import results, robust
from pcgmix_tpu_torch.exp.dirs import experiment_dir
from pcgmix_tpu_torch.exp.runner import main, run_grid
from pcgmix_tpu_torch.train import TrainConfig

MODELS = ["resnet9", "Potes", "Singstad_d10", "resnet9-5k"]
METHODS = ["base", "timemask(0.2)"]


def test_tables_equal_reference():
    assert robust.N_FRACTIONS == J_N_FRACTIONS
    assert robust._CP_TABLE == J_CP_TABLE


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("n_frac", J_N_FRACTIONS)
@pytest.mark.parametrize("method", sorted(J_CP_TABLE))
def test_hyperparameters_robust_equal_reference(method, n_frac, model):
    fields = dict(model=model, method=method, n_fraction=n_frac, num_epochs=7,
                  lr_max=0.5, experiments_root="exp")
    got = robust.hyperparameters_robust(TrainConfig(**fields))
    exp = jrobust(JTrainConfig(**fields))
    assert (got.method, got.num_epochs, got.lr_max) == (exp.method, exp.num_epochs, exp.lr_max)
    assert experiment_dir(got) == jexperiment_dir(exp)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    ds = synthetic_physionet_dict(num_wavs_train=16, num_wavs_test=6,
                                  segments_per_wav=2, sig_len=512, seed=1)
    path = root / "p.dat"
    utils.dict2file(ds, str(path))
    base = TrainConfig(model="resnet9-5k", num_epochs=2, batch_size=8,
                       experiments_root=str(root / "exp"), device="cpu")
    executed = run_grid(base, ds, METHODS, [1.0], [1], seed_datas=[1100001],
                        robust=False, progress=False)
    return {"ds": ds, "path": path, "base": base, "executed": executed, "root": root}


def test_run_dirs_are_read_back_by_the_jax_package(grid):
    executed = grid["executed"]
    assert [c.method for c in executed] == METHODS
    for cfg in executed:
        got = results.read_performance(cfg)
        exp = jresults.read_performance(cfg)
        assert sorted(got) == sorted(exp)
        assert exp["test_wav_preds"] == got["test_wav_preds"] and exp["test_wav_preds"]
        assert exp["epochs"] == [1, 2] and np.isfinite(exp["train_loss"]).all()
    jcfg = JTrainConfig(model="resnet9-5k", num_epochs=2, batch_size=8,
                        experiments_root=grid["base"].experiments_root)
    for method in METHODS:
        run = copy.deepcopy(jcfg)
        run.method = method
        res = jresults.read_experiments_all_dataseeds(run, [1.0], robust=False)
        assert res.num_runs == [1]


def test_rerun_trains_nothing(grid, capsys):
    assert run_grid(grid["base"], grid["ds"], METHODS, [1.0], [1],
                    seed_datas=[1100001], robust=False) == []
    out = capsys.readouterr().out.splitlines()
    assert out == [f"skip (done): {experiment_dir(c)}" for c in grid["executed"]]
    main(["--dataset-file", str(grid["path"]), "--device", "cpu", "--model", "resnet9-5k",
          "--methods", *METHODS, "--num-epochs", "2", "--batch-size", "8",
          "--seed-datas", "1100001", "--no-robust",
          "--experiments-root", grid["base"].experiments_root])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"skip (done): {experiment_dir(c)}" for c in grid["executed"]]


def test_the_results_cli_reads_the_grid(grid, capsys):
    results.main(["--experiments-root", grid["base"].experiments_root,
                  "--model", "resnet9-5k", "--methods", *METHODS,
                  "--num-epochs", "2", "--batch-size", "8", "--no-robust"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["n_frac", *METHODS]
    assert out[1].split()[0] == "1" and "±" in out[1]


def test_runner_flags_reach_the_runs(grid, tmp_path, monkeypatch, capsys):
    """--checkpoint-every 1 writes each run's checkpoints/, and with
    --steps-per-dispatch 2 and --no-device-cache the runs train in chunks
    of two steps, uploading their corpus anew."""
    from pcgmix_tpu_torch.train import loop

    seen = []
    train = loop._train
    monkeypatch.setattr(loop, "_train", lambda cfg, *a, **k: seen.append(cfg) or train(
        cfg, *a, **k))
    root = str(tmp_path / "exp")
    main(["--dataset-file", str(grid["path"]), "--device", "cpu", "--model", "resnet9-5k",
          "--methods", "durratiomixup", "--num-epochs", "2", "--batch-size", "8",
          "--seed-datas", "1100001", "--no-robust", "--experiments-root", root,
          "--checkpoint-every", "1", "--steps-per-dispatch", "2", "--no-device-cache"])
    (cfg,) = seen
    assert (cfg.checkpoint_every, cfg.steps_per_dispatch, cfg.device_cache) == (1, 2, False)
    ckpts = sorted(os.listdir(os.path.join(experiment_dir(cfg), "checkpoints")))
    assert [f for f in ckpts if f.startswith("ckpt_")] and len(ckpts) == 4
    capsys.readouterr()


@pytest.mark.parametrize("option,item", [
    # ported options (no item): the runner goes on to read the file
    pytest.param(["--gang"], None, id="option0-12"),
    pytest.param(["--gang-devices", "2"], None, id="option1-12"),
    pytest.param(["--gang-max-size", "4"], None, id="option2-12"),
    pytest.param(["--no-gang-fallback"], None, id="option3-12"),
    pytest.param(["--steps-per-dispatch", "4"], None, id="option4-11"),
    pytest.param(["--checkpoint-every", "1"], None, id="option5-11"),
    pytest.param(["--no-device-cache"], None, id="no-device-cache"),
    pytest.param(["--classical-space"], 13, id="option6-13"),
    # --latent-space is taken (no item): the runner goes on to read the file
    pytest.param(["--latent-space"], None, id="option7-6"),
    # --compute-dtype is taken (no item): the runner goes on to read the file
    pytest.param(["--compute-dtype", "bfloat16"], None, id="option8-3"),
    pytest.param(["--conv-impl", "matmul"], None, id="option9-12"),
])
def test_unported_options_raise(option, item):
    if item is None:
        with pytest.raises(FileNotFoundError, match="absent.dat"):
            main(["--dataset-file", "absent.dat", "--device", "cpu", *option])
        return
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        main(["--dataset-file", "absent.dat", "--device", "cpu", *option])


DEPENDENCY_METHODS = ["(saloptenv-1)durratiomixup", "(closestknn=8)durmixmagwarp(0.2,4)"]


@pytest.fixture(scope="module")
def over_ranks(grid, tmp_path_factory):
    """The runner over the two dependency methods with ``n_devices=2``:
    every run spawns two gloo ranks, the salopt method's provider reaching
    them pickled; the closest method's canonical embedder is given as a
    ResCNN checkpoint (training it takes 32 rows a batch)."""
    import torch

    from pcgmix_tpu_torch.latent import latent_pretrain_config
    from pcgmix_tpu_torch.models import build_model

    root = tmp_path_factory.mktemp("ranks")
    base = dataclasses.replace(grid["base"], n_devices=2, experiments_root=str(root))
    embedder = experiment_dir(latent_pretrain_config(base))
    os.makedirs(embedder)
    torch.save(build_model("ResCNN", 2, 4, 512).state_dict(), os.path.join(embedder, "model.pth"))
    executed = run_grid(base, grid["ds"], DEPENDENCY_METHODS, [1.0], [1],
                        seed_datas=[1100001], robust=False, progress=False)
    return executed


@pytest.mark.parametrize("method", DEPENDENCY_METHODS)
def test_dependency_methods_run_over_ranks(method, over_ranks):
    """A dependency method over data-parallel ranks trains after its
    dependency (the salopt method's durratiomixup run, itself over two
    ranks), and rank 0 writes finite losses and the weights."""
    executed = [c.method for c in over_ranks]
    assert executed == ["durratiomixup", "(saloptenv-1)durratiomixup",
                        "(closestknn=8)durmixmagwarp(0.2,4)"]
    cfg = over_ranks[executed.index(method)]
    assert cfg.n_devices == 2
    perf = utils.load_dict(os.path.join(experiment_dir(cfg), "performance.pkl"))
    assert perf["steps"][-1] > 0 and np.isfinite(perf["train_loss"]).all()
    assert os.path.exists(os.path.join(experiment_dir(cfg), "model.pth"))