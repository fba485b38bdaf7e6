"""Guards of the PyTorch port: it imports neither JAX nor the JAX package
nor the libraries the GPU machine lacks, and its entry points run on the
card unless the CPU is asked for."""

import ast
import pathlib

import pytest
import torch

import pcgmix_tpu_torch
from pcgmix_tpu_torch.data import synthetic_physionet_dict
from pcgmix_tpu_torch.train import TrainConfig, train_model

ROOT = pathlib.Path(pcgmix_tpu_torch.__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "sklearn", "pandas",
             "matplotlib", "pcgmix_tpu"}


def _port_sources():
    files = sorted((ROOT / "pcgmix_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_imports_nothing_forbidden(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    for required in ("chip_smoke.py", "pcgmix_tpu_torch/ops/mix_kernels.py",
                     "pcgmix_tpu_torch/ops/build.py", "pcgmix_tpu_torch/ops/conv_bn.py",
                     "pcgmix_tpu_torch/bench/conv_bn_fused.py",
                     "pcgmix_tpu_torch/models/potes.py",
                     "pcgmix_tpu_torch/train/loop.py",
                     "pcgmix_tpu_torch/train/gang.py",
                     "pcgmix_tpu_torch/parallel/dist.py",
                     "pcgmix_tpu_torch/exp/runner.py", "pcgmix_tpu_torch/exp/replicate.py",
                     "pcgmix_tpu_torch/exp/results.py", "pcgmix_tpu_torch/exp/paper.py",
                     "pcgmix_tpu_torch/exp/robust.py", "pcgmix_tpu_torch/ops/masks.py",
                     "pcgmix_tpu_torch/models/resnet9_2d.py",
                     "pcgmix_tpu_torch/data/umc.py",
                     "pcgmix_tpu_torch/ops/filtering.py",
                     "pcgmix_tpu_torch/ops/spectrogram.py",
                     "pcgmix_tpu_torch/data/corpus.py",
                     "pcgmix_tpu_torch/data/builder.py",
                     "pcgmix_tpu_torch/classical/dsp.py",
                     "pcgmix_tpu_torch/classical/features.py",
                     *(f"pcgmix_tpu_torch/models/{m}.py" for m in (
                         "layers", "fcn", "rescnn", "resnet_ts", "singstad",
                         "tsai_inception", "tsai_xresnet", "tsai_seq", "tsai_misc"))):
        assert required in names
    for source in ("mix_kernels.cu", "conv_bn_stats.cu"):
        assert (ROOT / "pcgmix_tpu_torch/ops/csrc" / source).exists()


def test_train_config_defaults_to_cuda():
    assert TrainConfig().device == "cuda"


def test_train_model_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    ds = synthetic_physionet_dict(num_wavs_train=4, num_wavs_test=2,
                                  segments_per_wav=2, sig_len=256, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_model(TrainConfig(model="resnet9-5k", batch_size=4, num_epochs=1,
                                save_artifacts=False), ds)


def test_spawned_ranks_import_neither_jax_nor_the_jax_package():
    """A rank that the data-parallel route spawns starts from a fresh
    interpreter and imports only the port (here it reports its modules)."""
    from pcgmix_tpu_torch.parallel import spawn

    modules = spawn(eval, 2, "gloo", ("sorted(__import__('sys').modules)",))
    roots = {m.split(".")[0] for m in modules}
    assert "pcgmix_tpu_torch" in roots and "torch" in roots
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)


def test_kernel_wrappers_refuse_other_devices():
    from pcgmix_tpu_torch.ops import piecewise_mix_pairs, piecewise_mix_prepaired

    x = torch.zeros(2, 1, 8, device="meta")
    i = torch.zeros(2, dtype=torch.int32, device="meta")
    p = torch.zeros(2, 1, dtype=torch.int32, device="meta")
    a = torch.zeros(2, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        piecewise_mix_pairs(x, i, i, p, p, p, p, a)
    with pytest.raises(ValueError, match="unsupported device"):
        piecewise_mix_prepaired(x, x, p, p, p, p, a)


@pytest.mark.parametrize("module", ["runner", "replicate"])
def test_grid_entry_points_default_to_cuda_and_refuse_a_missing_card(module, tmp_path):
    import importlib

    mod = importlib.import_module(f"pcgmix_tpu_torch.exp.{module}")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    argv = {"runner": ["--dataset-file", str(tmp_path / "absent.dat")],
            "replicate": ["--mini", "--experiments-root", str(tmp_path)]}[module]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not any(tmp_path.iterdir())  # refused before any work


@pytest.mark.parametrize("dataset,method", [("PhysioNet", "latentmixup"),
                                            ("PhysioNet(spec128)", "durratiomixup"),
                                            ("UMC", "(UMC-subset)durratiocutmix"),
                                            ("PhysioNet", "manifold-cutmix")])
def test_latent_and_spectrogram_paths_refuse_a_missing_card(dataset, method):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    from pcgmix_tpu_torch.data import synthetic_spectrogram_dict, synthetic_umc_dict

    ds = {"PhysioNet": lambda: synthetic_physionet_dict(4, 2, 2, sig_len=256, seed=1),
          "PhysioNet(spec128)": lambda: synthetic_spectrogram_dict(4, 2, 2, size=32, seed=1),
          "UMC": lambda: synthetic_umc_dict(1, sig_len=256, seed=1)}[dataset]()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_model(TrainConfig(dataset=dataset, method=method, batch_size=4,
                                num_epochs=1, save_artifacts=False), ds)


@pytest.mark.parametrize("model", ["FCN", "Singstad_d10", "LSTM"])
def test_zoo_models_refuse_a_missing_card(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot be shown")
    ds = synthetic_physionet_dict(4, 2, 2, sig_len=256, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_model(TrainConfig(model=model, method="durmixmagwarp(0.2,4)", batch_size=4,
                                num_epochs=1, save_artifacts=False), ds)


def test_spectrogram_blends_go_through_the_kernel_wrappers():
    """A spectrogram batch's keep-duration blend reaches K1's and K3's
    wrappers (here on a device that has neither kernel nor plain version,
    so they raise): no route around the kernels."""
    import numpy as np

    from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine

    eng = AugmentEngine(AugmentConfig("durmixtimemask(0.1)", 4, 1, 16, spectrogram=True,
                                      spec_freq=16))
    frames = np.tile(np.array([0, 2, 5, 7, 12]), (4, 1))
    plan = eng.plan(0, frames, np.array([0, 1, 0, 1]))
    x = torch.zeros(4, 1, 16, 16, device="meta")
    t = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        eng.apply(x, t, plan.arrays)
    with pytest.raises(ValueError, match="unsupported device"):
        eng.apply_prepaired(x, x, t, t, plan.arrays)


@pytest.mark.parametrize("method", ["cutmix", "(smooth)labelcutmix", "cutmix(ch)",
                                    "durratiocutmix"])
def test_cuts_and_concat_joins_go_through_the_kernel_wrappers(method):
    """The keep-duration cut and the concat family reach K1's wrapper on
    one device and K3's on a rank's block (here on a device that has
    neither kernel nor plain version, so they raise)."""
    import numpy as np

    from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine

    eng = AugmentEngine(AugmentConfig(method, 4, 4, 16))
    frames = np.tile(np.array([0, 2, 5, 7, 12]), (4, 1))
    plan = eng.plan(0, frames, np.array([0, 1, 0, 1]), ["a", "b", "c", "d"])
    x = torch.zeros(4, 4, 16, device="meta")
    t = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        eng.apply(x, t, plan.arrays)
    with pytest.raises(ValueError, match="unsupported device"):
        eng.apply_prepaired(x, x, t, t, plan.arrays)
