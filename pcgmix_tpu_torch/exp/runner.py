"""Experiment grid runner + CLI (counterpart: ``pcgmix_tpu/exp/runner.py``).

The reference drives experiments from notebook cells that loop
``train_model`` over method × n_fraction × seed_data × seed grids with
``hyperparameters_robust`` rewriting and ``experiment_already_done``
resume-skipping (experiments_timeseries.ipynb cells 4/9).  This module is
the CLI equivalent; it trains on the card unless ``--device cpu`` is given:

  python -m pcgmix_tpu_torch.exp.runner --dataset-file physionet.dat \\
      --methods base durratiomixup "durmixmagwarp(0.2,4)" \\
      --n-fractions 0.1 1.0 --seeds 1 2 3

A spectrogram .dat trains the 2-D ResNet9 with the 2-D method ladder and
the spectrogram seed grids: ``--dataset "PhysioNet(spec128)"``.  A UMC
.dat takes its patient folds as the data seeds:
``--dataset UMC --seed-datas 1 2 3 4 5 6 7 8 9 10`` (also ``UMC(spec128)``,
``UMC(spec64)``).

It prints ``run: <dir>`` before each run it trains, ``skip (done): <dir>``
for each finished one, and after each run ``done: <dir>`` with its wall
time, steps, kernel launches and the host ms per step of the
model-in-the-loop phases (:mod:`pcgmix_tpu_torch.timing`).

(salopt…) and (closestknn/closestbins) methods depend on another run, as
in the JAX runner: a pretrained checkpoint of the same configuration with
the method swapped (``base``, or for the '-1'/'-2' variants the
robust-scheduled ``durratiomixup`` / ``durmixmagwarp(0.2,4)``), or the
canonical frozen ResCNN embedder.  The runner trains a missing dependency
first, printing ``run (salopt dependency): <dir>`` or ``run (latent
dependency): <dir>``, and loads its ``model.pth``.  ``--latent-space``
sets ``TrainConfig.latent_space`` but passes no embedder, as the JAX
runner does, so it writes no dumps.

``--gang`` trains the grid points that differ only in ``seed_data`` and
``seed`` together, as gangs (:mod:`pcgmix_tpu_torch.train.gang`): it
prints ``gang of S: <method> nfrac=… seed_datas=[…]`` before each gang,
``done (gang): <dir>`` for each member and ``gang done: …`` with its wall
time and launches after it.  The points a gang cannot take (the
dependency methods, the live-model methods, the recurrent models) and
groups of one train through ``train_model`` as before.
``--gang-max-size`` chunks larger groups (default: the device's memory
over :func:`~pcgmix_tpu_torch.train.gang.estimate_gang_max_size`, 0: no
chunks), ``--gang-devices N`` splits each gang's members over N ranks, and
a gang that fails is retrained member by member unless
``--no-gang-fallback`` is given.  ``--conv-impl matmul`` computes the
ResNet9 and Potes convolutions as shifted matmuls.  ``--compute-dtype
bfloat16`` trains in the bf16 compute mode (``TrainConfig.compute_dtype``;
float32, the default, is the parity route); a gang's auto-size is reckoned
per dtype.  The classical dumps are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import time

import numpy as np

from pcgmix_tpu_torch import utils
from pcgmix_tpu_torch.augment.methods import parse_method
from pcgmix_tpu_torch.augment.pairing import LATENT_PAIRINGS
from pcgmix_tpu_torch.data.umc import FOLDS
from pcgmix_tpu_torch.exp.dirs import (
    experiment_already_done,
    experiment_dir,
    require_checkpoint,
)
from pcgmix_tpu_torch.exp.robust import SEED_DATA_GRIDS, hyperparameters_robust
from pcgmix_tpu_torch.ops import launch_counts, reset_launch_counts
from pcgmix_tpu_torch.timing import host_times, reset_host_times
from pcgmix_tpu_torch.train.loop import (
    TrainConfig,
    resolve_device,
    train_model,
)


def _salopt_dependency(cfg: TrainConfig, robust: bool) -> TrainConfig | None:
    """The pretrained run a (salopt…) method depends on (JAX
    ``exp/runner.py:25-42``): the same config with method 'base' (salopt
    model 0) or the robust-rewritten 'durratiomixup' /
    'durmixmagwarp(0.2,4)' ('-1'/'-2'); reference saliency.py:26-37.  None
    when the method has no salopt dependency."""
    from pcgmix_tpu_torch.saliency import SALOPT_PRETRAIN_METHODS

    spec = parse_method(cfg.method, spectrogram=cfg.spectrogram)
    if spec.salopt is None:
        return None
    dep = copy.deepcopy(cfg)
    dep.method = SALOPT_PRETRAIN_METHODS[spec.salopt_model]
    if robust and spec.salopt_model:
        dep = hyperparameters_robust(dep)
    dep.save_artifacts = True  # the dependency's checkpoint is the artifact
    return dep


def _salopt_checkpoint_dir(cfg: TrainConfig, robust: bool, method: str) -> str:
    """The run dir of ``cfg``'s salopt dependency (``method`` is the one its
    salopt model names): a module-level function, so that the provider
    pickles into spawned ranks."""
    return experiment_dir(_salopt_dependency(cfg, robust))


def _latent_dependency(cfg: TrainConfig) -> TrainConfig | None:
    """The frozen-embedder run a (closestknn/closestbins) method depends on:
    the canonical ResCNN base run (latent_space.py:27-29).  None when the
    method has no latent pairing."""
    from pcgmix_tpu_torch.latent import latent_pretrain_config

    spec = parse_method(cfg.method, spectrogram=cfg.spectrogram)
    if spec.pairing not in LATENT_PAIRINGS:
        return None
    return latent_pretrain_config(cfg)


def run_grid(
    base_cfg: TrainConfig,
    dataset: dict,
    methods,
    n_fractions,
    seeds,
    seed_datas=None,
    robust: bool = True,
    skip_done: bool = True,
    progress: bool = True,
    gang: bool = False,
    gang_devices=None,
    gang_max_size=None,
    gang_fallback: bool = True,
) -> list[TrainConfig]:
    """Run every grid point in order, skipping finished runs.  Returns the
    configs that were executed, dependency runs included.

    A (salopt…) or (closestknn/closestbins) point first trains the run it
    depends on when that run is not done (JAX ``exp/runner.py:131-152``),
    then loads that run's ``model.pth``.

    ``gang`` trains the points that differ only in seed_data/seed as gangs
    (JAX ``exp/runner.py:180-330``): ``gang_max_size`` members at most
    (None: from the device's memory; 0: no limit), the members split over
    ``gang_devices`` ranks where they divide, and with ``gang_fallback`` a
    failed gang's members retrained one by one."""
    resolve_device(base_cfg.device)
    if base_cfg.dataset.startswith("UMC") and not (
            seed_datas and all(s in FOLDS for s in seed_datas)):
        raise ValueError("a UMC grid takes its train folds as data seeds: "
                         "--seed-datas with values in 1..10")
    executed = []

    def train(cfg, **hooks):
        reset_launch_counts()
        reset_host_times()
        t0 = time.time()
        perf = train_model(cfg, dataset, **hooks)
        wall = time.time() - t0
        executed.append(cfg)
        if progress:
            steps = perf["steps"][-1]
            launches = {k: v for k, v in launch_counts().items() if v}
            host = {k: ms / steps for k, (ms, _) in host_times().items()}
            print(f"done: {experiment_dir(cfg)} in {wall:.3f} s, {steps} steps, "
                  f"launches {json.dumps(launches)}, host ms per step "
                  f"{json.dumps(host)}", flush=True)

    def salopt_provider_for(cfg):
        """The saliency provider of one (salopt…) config: each checkpoint
        dir resolved through :func:`_salopt_dependency`, so the run trained
        first is the run loaded."""
        from pcgmix_tpu_torch.saliency import make_pretrained_saliency_fn

        return make_pretrained_saliency_fn(
            cfg, functools.partial(_salopt_checkpoint_dir, cfg, robust))

    def run_one(cfg):
        """Train ``cfg`` after its dependencies; a point that one of them
        completed meanwhile (a salopt method listed before 'base') skips."""
        if skip_done and experiment_already_done(cfg):
            if progress:
                print(f"skip (done): {experiment_dir(cfg)}")
            return
        hooks = {}
        lat_dep = _latent_dependency(cfg)
        if lat_dep is not None:
            if not experiment_already_done(lat_dep):
                if progress:
                    print(f"run (latent dependency): {experiment_dir(lat_dep)}", flush=True)
                train(lat_dep)
            # train_model loads the embedder from this run dir itself
            require_checkpoint(experiment_dir(lat_dep), f"{cfg.method!r}'s latent pairing")
        dep = _salopt_dependency(cfg, robust)
        if dep is not None:
            if not experiment_already_done(dep):
                if progress:
                    print(f"run (salopt dependency): {experiment_dir(dep)}", flush=True)
                train(dep)
            require_checkpoint(experiment_dir(dep), f"{cfg.method!r}'s saliency model")
            hooks["saliency_model_provider"] = salopt_provider_for(cfg)
        if progress:
            print(f"run: {experiment_dir(cfg)}", flush=True)
        train(cfg, **hooks)

    points = []
    for method in methods:
        for n_frac in n_fractions:
            if seed_datas is not None:
                sds = seed_datas
            elif n_frac in SEED_DATA_GRIDS:
                grid_1d, grid_2d = SEED_DATA_GRIDS[n_frac]
                sds = list(grid_2d if base_cfg.spectrogram else grid_1d)
            else:
                sds = [base_cfg.seed_data]
            for seed_data in sds:
                for seed in seeds:
                    cfg = copy.deepcopy(base_cfg)
                    cfg.method = method
                    cfg.n_fraction = n_frac
                    cfg.seed_data = seed_data
                    cfg.seed = seed
                    if robust:
                        cfg = hyperparameters_robust(cfg)
                    points.append(cfg)
    if not gang:
        for cfg in points:
            run_one(cfg)
        return executed
    _run_gangs(points, dataset, run_one, executed, skip_done, progress, gang_devices,
               gang_max_size, gang_fallback)
    return executed


def _train_rows(dataset: dict) -> dict:
    """The level of a dataset dict that holds the train corpus."""
    return dataset["train"] if "train" in dataset and "test" in dataset else dataset


def _run_gangs(points, dataset, run_one, executed, skip_done, progress, gang_devices,
               gang_max_size, gang_fallback) -> None:
    """The gang half of :func:`run_grid`: the points not done, grouped into
    gangs (JAX ``exp/runner.py:180-330``); groups of one and the points a
    gang cannot take go through ``run_one``."""
    from pcgmix_tpu_torch.train.gang import (
        estimate_gang_max_size,
        gang_profitable,
        group_gangable,
        train_gang,
    )

    def done(cfg):
        if skip_done and experiment_already_done(cfg):
            if progress:
                print(f"skip (done): {experiment_dir(cfg)}")
            return True
        return False

    pending = [cfg for cfg in points if not done(cfg)]
    advised, sizes = set(), {}

    def advise(cfg):
        if cfg.model in advised:
            return
        advised.add(cfg.model)
        if not gang_profitable(cfg) and progress:
            print(f"gang advisory: {cfg.model} has 1M parameters or more; on an NVIDIA "
                  "H100 80GB HBM3 at 700 W ResNet9's gangs trained 0.50-0.59x the "
                  "member-steps/s of sequential runs (S = 2-8; 0.91-0.94x at S = 4 "
                  "with --conv-impl matmul), Potes' 1.30-1.77x (S = 4-8); keeping "
                  "the gang")

    def max_size(cfg):
        if gang_max_size is not None:
            return gang_max_size
        key = (cfg.model, cfg.dataset, cfg.batch_size, cfg.op, cfg.num_channels,
               cfg.conv_impl, cfg.compute_dtype)
        if key not in sizes:
            # a member's input row, read from the corpus: (1, F, T) or (C, T)
            d = _train_rows(dataset)
            rows = len(d["label"])
            sample = ((1, *np.shape(d["data"])[1:]) if cfg.spectrogram
                      else (cfg.num_channels, np.shape(next(iter(d["data"].values())))[-1]))
            sizes[key] = estimate_gang_max_size(
                cfg, rows, corpus_bytes=rows * int(np.prod(sample)) * 4, sample_shape=sample)
            if progress:
                print(f"gang auto-size: S_max={sizes[key]} ({cfg.model}, batch "
                      f"{cfg.batch_size}, {cfg.op}, {cfg.compute_dtype}) — override with "
                      "--gang-max-size")
        return sizes[key]

    for full in group_gangable(pending):
        k = max_size(full[0]) if len(full) > 1 else 0
        for group in ([full[i:i + k] for i in range(0, len(full), k)] if k else [full]):
            group = [cfg for cfg in group if not done(cfg)]
            if len(group) < 2:
                for cfg in group:
                    run_one(cfg)
                continue
            advise(group[0])
            n_dev = gang_devices if gang_devices and len(group) % gang_devices == 0 else None
            if progress:
                note = ("" if n_dev == gang_devices or not gang_devices else
                        f" (size {len(group)} not divisible by {gang_devices} devices — "
                        "running unsharded)")
                print(f"gang of {len(group)}: {group[0].method} "
                      f"nfrac={group[0].n_fraction} "
                      f"seed_datas={[c.seed_data for c in group]}{note}", flush=True)
            reset_launch_counts()
            t0 = time.time()
            try:
                perfs = train_gang(group, dataset, n_devices=n_dev, progress=progress)
            except Exception as e:  # noqa: BLE001 - the grid goes on without the gang
                if not gang_fallback:
                    raise
                print(f"gang of {len(group)} ({group[0].method}) FAILED "
                      f"({type(e).__name__}: {e}) — falling back to sequential runs "
                      "(pass --no-gang-fallback to surface gang failures instead)",
                      flush=True)
                for cfg in group:
                    run_one(cfg)
                continue
            executed.extend(group)
            if progress:
                launches = {k: v for k, v in launch_counts().items() if v}
                for cfg in group:
                    print(f"done (gang): {experiment_dir(cfg)}")
                print(f"gang done: {len(group)} members in {time.time() - t0:.3f} s, "
                      f"{perfs[0]['steps'][-1]} steps each, launches "
                      f"{json.dumps(launches)}", flush=True)


def _refuse(args) -> None:
    """Raise for the JAX runner's options that the port does not have yet,
    naming the ROADMAP queue 1 item each waits for."""
    refused = [
        (args.classical_space, "--classical-space: classical feature dumps", 13),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1 item {item})")


def main(argv=None):
    p = argparse.ArgumentParser(description="PCGmix experiment grid runner (PyTorch)")
    p.add_argument("--dataset-file", required=True, help=".dat dataset dict")
    p.add_argument("--dataset", default="PhysioNet")
    p.add_argument("--model", default="resnet9")
    p.add_argument("--methods", nargs="+", default=["base"])
    p.add_argument("--n-fractions", nargs="+", type=float, default=[1.0])
    p.add_argument("--seeds", nargs="+", type=int, default=[1])
    p.add_argument("--seed-datas", nargs="+", type=int, default=None)
    p.add_argument("--num-epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr-max", type=float, default=0.01)
    p.add_argument("--op", default="adam")
    p.add_argument("--num-channels", type=int, default=4)
    p.add_argument("--valid", action="store_true")
    p.add_argument("--no-robust", action="store_true")
    p.add_argument("--experiments-root", default="experiments")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cpu' only when asked for)")
    p.add_argument("--cvd-map-csv", default=None,
                   help="cvds_map.csv (columns wav,diagnosis) for (sameCVD) methods")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks (default: every visible card)")
    p.add_argument("--eval-batch-size", type=int, default=1000)
    p.add_argument("--true-seed", type=int, default=None,
                   help="override the hardcoded train-balance sampling seed 18")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train steps per dispatch; on a card K>1 replays one CUDA "
                        "graph of K steps")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="epochs between full-state checkpoints (a rerun resumes "
                        "from the latest)")
    p.add_argument("--no-device-cache", action="store_true",
                   help="re-upload each run's corpus instead of reusing the device "
                        "tensors of an equal one")
    p.add_argument("--latent-space", action="store_true",
                   help="set TrainConfig.latent_space (as in the JAX runner, no "
                        "embedder is passed, so nothing is dumped)")
    p.add_argument("--gang", action="store_true",
                   help="train the points that differ only in seed_data/seed together, "
                        "as gangs (pcgmix_tpu_torch.train.gang); the others run one by one")
    p.add_argument("--gang-devices", type=int, default=None,
                   help="split each gang's members over this many ranks (one per card)")
    p.add_argument("--gang-max-size", type=int, default=None,
                   help="members per gang at most (default: from the device's memory; "
                        "0: no limit)")
    p.add_argument("--no-gang-fallback", action="store_true",
                   help="let a failed gang stop the grid instead of retraining its "
                        "members one by one")
    p.add_argument("--conv-impl", default="xla", choices=["xla", "matmul"],
                   help="'matmul': the ResNet9 and Potes convolutions as shifted matmuls")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16: the bf16 compute mode; float32 keeps the parity route")
    # the JAX runner's options that wait for later slices: they raise
    p.add_argument("--classical-space", action="store_true")
    args = p.parse_args(argv)
    _refuse(args)
    resolve_device(args.device)

    dataset = utils.file2dict(args.dataset_file)
    base_cfg = TrainConfig(
        dataset=args.dataset,
        model=args.model,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        lr_max=args.lr_max,
        op=args.op,
        num_channels=args.num_channels,
        valid=args.valid,
        experiments_root=args.experiments_root,
        cvd_map=args.cvd_map_csv,
        n_devices=args.n_devices,
        eval_batch_size=args.eval_batch_size,
        true_seed=args.true_seed,
        device=args.device,
        latent_space=args.latent_space,
        steps_per_dispatch=args.steps_per_dispatch,
        checkpoint_every=args.checkpoint_every,
        device_cache=not args.no_device_cache,
        conv_impl=args.conv_impl,
        compute_dtype=args.compute_dtype,
    )
    run_grid(
        base_cfg,
        dataset,
        args.methods,
        args.n_fractions,
        args.seeds,
        seed_datas=args.seed_datas,
        robust=not args.no_robust,
        gang=args.gang,
        gang_devices=args.gang_devices,
        gang_max_size=args.gang_max_size,
        gang_fallback=not args.no_gang_fallback,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
