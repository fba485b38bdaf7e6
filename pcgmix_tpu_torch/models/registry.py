"""Model factory keyed by the reference's model-name strings
(counterpart: ``pcgmix_tpu/models/registry.py``; reference
train_model.py:294-386).  The port knows all 39 names of the JAX package:
the ResNet9 and Potes presets, FCN, FCN(custom), ResCNN, ResNet,
Singstad_d3/d6/d10 and the 16 tsai names, under the same aliases (the
"Plus" names, FCNPlus and ResNetPlus map to the classes the JAX package
maps them to); for the spectrogram datasets, the 2-D ResNet9."""

from __future__ import annotations

from typing import Optional

from torch import nn

from pcgmix_tpu_torch.models.fcn import FCN
from pcgmix_tpu_torch.models.layers import resolve_compute_dtype
from pcgmix_tpu_torch.models.potes import POTES_PRESETS, Potes
from pcgmix_tpu_torch.models.rescnn import ResCNN
from pcgmix_tpu_torch.models.resnet9 import RESNET9_PRESETS, ResNet9_1D
from pcgmix_tpu_torch.models.resnet9_2d import ResNet9_2D
from pcgmix_tpu_torch.models.resnet_ts import ResNetTS
from pcgmix_tpu_torch.models.singstad import SingstadInceptionTime
from pcgmix_tpu_torch.models.tsai_inception import InceptionTime, XceptionTime
from pcgmix_tpu_torch.models.tsai_misc import MWDN, XCM, OmniScaleCNN
from pcgmix_tpu_torch.models.tsai_seq import GMLP, TsaiRNN
from pcgmix_tpu_torch.models.tsai_xresnet import XResNet1d18

TSAI_NAMES = (
    "ResNetPlus", "XResNet1d18", "XResNet1d18Plus", "InceptionTime", "InceptionTimePlus",
    "XceptionTime", "XceptionTimePlus", "gMLP", "XCM", "XCMPlus", "FCNPlus", "RNN",
    "LSTM", "GRU", "mWDN", "OmniScaleCNN",
)

MODEL_NAMES = (
    tuple(RESNET9_PRESETS) + tuple(POTES_PRESETS)
    + ("FCN", "FCN(custom)", "ResCNN", "ResNet", "Singstad_d3", "Singstad_d6",
       "Singstad_d10")
    + TSAI_NAMES
)

#: the datasets of (N, 1, F, T) mel spectrograms, which take the 2-D ResNet9
SPECTROGRAM_DATASETS = ("PhysioNet(spec128)", "UMC(spec128)", "UMC(spec64)")

#: each alias → the name whose class and arguments it takes
ALIASES = {"FCNPlus": "FCN", "ResNetPlus": "ResNet", "InceptionTimePlus": "InceptionTime",
           "XceptionTimePlus": "XceptionTime", "XResNet1d18Plus": "XResNet1d18",
           "XCMPlus": "XCM"}

#: the families that honor ``compute_dtype`` (after ALIASES); the others
#: (FCN, ResCNN, ResNet, Singstad_d*, RNN, LSTM, GRU) take it and stay float32
COMPUTE_DTYPE_FAMILIES = ("InceptionTime", "XceptionTime", "XResNet1d18", "gMLP",
                          "XCM", "mWDN", "OmniScaleCNN")


def build_model(name: str, num_classes: int = 2, num_channels: int = 4,
                sig_len: int = 2500, *, seed: int = 0, dataset: str = "PhysioNet",
                freq: Optional[int] = None, conv_impl: str = "xla",
                compute_dtype: Optional[str] = None) -> nn.Module:
    """Instantiate a model by its reference name; ``seed`` seeds the
    model's own random draws (Potes' dropout masks).  A spectrogram
    ``dataset`` selects the 2-D variant of ``"resnet9"`` for inputs of
    ``freq`` × ``sig_len`` (square when ``freq`` is None).  gMLP, XCM,
    OmniScaleCNN and mWDN are sized for inputs of ``sig_len`` steps.
    ``conv_impl="matmul"`` computes the 1-D convolutions of the ResNet9 and
    Potes presets as shifted matmuls; the other models ignore it, as in
    the JAX registry (``pcgmix_tpu/models/registry.py:85-115``).

    ``compute_dtype`` (None or ``"float32"``, or ``"bfloat16"``;
    ``TrainConfig.compute_dtype``) names the layers' compute dtype, honored as
    the JAX registry honors it (``registry.py:90-95``): by the ResNet9 (1-D
    and 2-D) and Potes presets and the families of
    :data:`COMPUTE_DTYPE_FAMILIES`; the others take it and stay float32.
    Parameters and running statistics are float32 either way."""
    dt = resolve_compute_dtype(compute_dtype)
    if dataset in SPECTROGRAM_DATASETS:
        if name != "resnet9":
            raise ValueError(f"2-D dataset {dataset!r} supports model 'resnet9' only")
        return ResNet9_2D(num_classes, RESNET9_PRESETS[name],
                          sig_len if freq is None else freq, sig_len, compute_dtype=dt)
    if name in RESNET9_PRESETS:
        return ResNet9_1D(num_classes, RESNET9_PRESETS[name], num_channels, sig_len,
                          conv_impl=conv_impl, compute_dtype=dt)
    if name in POTES_PRESETS:
        return Potes(num_classes, num_channels=num_channels, sig_len=sig_len,
                     seed=seed, conv_impl=conv_impl, compute_dtype=dt,
                     **POTES_PRESETS[name])
    name = ALIASES.get(name, name)
    c = dict(num_channels=num_channels)
    if name in COMPUTE_DTYPE_FAMILIES:
        c["compute_dtype"] = dt
    t = dict(c, sig_len=sig_len)
    if name == "FCN":
        return FCN(num_classes, **c)
    if name == "FCN(custom)":
        return FCN(num_classes, layers=(64, 128, 64), **c)
    if name == "ResCNN":
        return ResCNN(num_classes, **c)
    if name == "ResNet":
        return ResNetTS(num_classes, **c)
    if name in ("Singstad_d3", "Singstad_d6", "Singstad_d10"):
        return SingstadInceptionTime(num_classes, int(name.split("_d")[1]), **c)
    if name == "InceptionTime":
        return InceptionTime(num_classes, **c)
    if name == "XceptionTime":
        return XceptionTime(num_classes, **c)
    if name == "XResNet1d18":
        return XResNet1d18(num_classes, **c)
    if name in ("RNN", "LSTM", "GRU"):
        return TsaiRNN(num_classes, cell_type=name.lower(), **c)
    if name == "gMLP":
        return GMLP(num_classes, **t)
    if name == "XCM":
        return XCM(num_classes, **t)
    if name == "mWDN":
        return MWDN(num_classes, **t)
    if name == "OmniScaleCNN":
        return OmniScaleCNN(num_classes, **t)
    raise ValueError(f"unknown model {name!r}; available: {', '.join(MODEL_NAMES)}")


def max_latent_depth(name: str) -> int:
    """Largest depth of latentmixup's depth draw (reference
    augmentations.py:1484-1494).  Raises for a model without a split
    (part='first'/'second') forward."""
    if name in ("FCN", "FCN(custom)"):
        return 4
    if name.startswith("Potes"):
        return 1
    if name == "ResCNN":
        return 5
    if name in RESNET9_PRESETS or name == "Singstad_d10":
        return 3
    raise NotImplementedError(
        f"latentmixup needs a split (part='first'/'second') forward, which "
        f"{name!r} does not implement (nor does the reference's); supported: "
        "resnet9 presets, Potes presets, FCN(+custom), ResCNN, Singstad_d10"
    )


def count_parameters(model: nn.Module) -> int:
    """Trainable-parameter count (reference train_model.py:162-163)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
