"""Per-n_fraction apply-probability schedules and seed grids (counterpart:
``pcgmix_tpu/exp/robust.py``, of which this is a copy).

Parity target: read_experiments.hyperparameters_robust
(read_experiments.py:151-218) — for PhysioNet with resnet9/Potes/Singstad_d10
it pins epochs/lr and appends a '+cp' apply-probability suffix to the method
string, with cp looked up per n_fraction; and the seed_data grids used for
the published tables (read_experiments.py:20-59).
"""

from __future__ import annotations

N_FRACTIONS = [0.015, 0.052, 0.1, 0.2, 0.3, 0.4, 0.6, 0.8, 1.0]

# method → cp per n_fraction (read_experiments.py:161-211)
_CP_TABLE = {
    "durmixmagwarp(0.2,4)":        [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "durratiomixup":               [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "mixup(same)":                 [1.0, 1.0, 1.0, 0.8, 0.6, 0.4, 0.2, 0.2, 0.2],
    "latentmixup":                 [1.0, 1.0, 1.0, 1.0, 0.6, 0.6, 0.2, 0.2, 0.2],
    "magnitudewarp(0.2,4)":        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.8, 0.4, 0.4],
    "timewarp(0.05,4)":            [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.2, 0.2, 0.2],
    "respiratoryscale(12,20)":     [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.2, 0.2, 0.2],
    "timemask(0.2)":               [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "gaussiannoise(25,40)":        [1.0, 1.0, 1.0, 1.0, 0.8, 0.6, 0.4, 0.2, 0.2],
    "(sameCVD)durmixmagwarp(0.2,4)":   [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "(samePCG)durmixmagwarp(0.2,4)":   [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "(sameDataset)durmixmagwarp(0.2,4)": [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "(mixAll)durmixmagwarp(0.2,4)":    [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "(sameCVD)durratiomixup":      [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "freqmask(0.1)":               [1.0, 1.0, 0.8, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "timemask(0.1)":               [1.0, 1.0, 0.8, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
    "cutout(0.25,0.25)":           [1.0, 1.0, 1.0, 0.8, 0.6, 0.6, 0.4, 0.2, 0.2],
}

# seed_data ranges per n_fraction for the published grids
# (read_experiments.py:20-59): (1-D range, spectrogram range).
SEED_DATA_GRIDS = {
    0.015: (range(1001001, 1001334), range(1001001, 1001201)),
    0.052: (range(1005001, 1005101), range(1005001, 1005061)),
    0.1:   (range(1010001, 1010051), range(1010001, 1010031)),
    0.2:   (range(1020001, 1020026), range(1020001, 1020016)),
    0.3:   (range(1030001, 1030017), range(1030001, 1030011)),
    0.4:   (range(1040001, 1040013), range(1040001, 1040009)),
    0.6:   (range(1060001, 1060009), range(1060001, 1060006)),
    0.8:   (range(1080001, 1080007), range(1080001, 1080005)),
    1.0:   ([1100001], [1100001]),
}


def hyperparameters_robust(cfg):
    """Mutate cfg with the robust schedule (read_experiments.py:151-218):
    PhysioNet + {resnet9, Potes}: 50 epochs, lr_max 0.01; Singstad_d10: 30
    epochs, lr_max 1e-5; then append '+cp' to the method unless 'base'.
    Returns cfg for chaining; non-matching configs pass through unchanged."""
    if cfg.dataset not in ("PhysioNet", "PhysioNet(spec128)"):
        return cfg
    if cfg.model not in ("resnet9", "Potes", "Singstad_d10"):
        return cfg
    if cfg.model in ("resnet9", "Potes"):
        cfg.num_epochs = 50
        cfg.lr_max = 0.01
    else:
        cfg.num_epochs = 30
        cfg.lr_max = 0.00001
    if cfg.method == "base":
        return cfg
    if cfg.method in _CP_TABLE and cfg.n_fraction in N_FRACTIONS:
        # the published '+cp' table covers exactly the 9 grid n_fractions
        # (read_experiments.py:160-166); custom fractions run un-suffixed
        # instead of raising
        cp = _CP_TABLE[cfg.method][N_FRACTIONS.index(cfg.n_fraction)]
        cfg.method = f"{cfg.method}+{cp}"
    return cfg
