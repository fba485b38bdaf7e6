"""Parser for the method-string DSL (the de-facto public API of the
reference's augmentation layer, SURVEY.md §2.3).

A method string composes a base method with modifiers, e.g.::

    "durmixmagwarp(0.2,4)+0.8"
    "(sameCVD)(rand)durratiomixup+0.6"
    "(saloptenv-1)durratiomixup"
    "(closestknn=8)durmixmagwarp(0.2,4)"

The reference dispatches by substring matching in a fixed priority order
(augmentations.py:731-1633; augmentations2d.py:283-617).  This parser
reproduces that order exactly so composed strings resolve to the same
handler.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

# 1-D dispatch ladder: (canonical name, guard) in the order the reference's
# augment() tests them.  A guard is a predicate on the method string applied
# *in addition* to the substring hit, mirroring the reference's composed
# `in`/`not in` conditions.
_LADDER_1D = [
    ("durmixrespscale", lambda m: True),
    ("respiratoryscale", lambda m: True),
    ("timemask", lambda m: True),
    (
        "mixup",
        lambda m: "latentmixup" not in m and "durratiomixup" not in m,
    ),
    ("durmixmagwarp", lambda m: True),
    ("durratiomixup", lambda m: True),
    ("wav-durratiocutmix", lambda m: True),
    ("timewarp", lambda m: True),
    ("magnitudewarp", lambda m: True),
    ("gaussiannoise", lambda m: True),
    (
        "(UMC-subset)durratiocutmix",
        lambda m: "(plus)" not in m and "(plusplus)" not in m,
    ),
    (
        "durratiocutmix",
        lambda m: "(plus)" not in m
        and "(plusplus)" not in m
        and "(UMC" not in m
        and "wav-durratiocutmix" not in m,
    ),
    ("lengthcutmix", lambda m: True),
    ("datasetcutmix", lambda m: True),
    ("wavcutmix", lambda m: "durratiowavcutmix" not in m),
    ("lc-nointrusion", lambda m: True),
    ("labelcutmix", lambda m: True),
    ("swapsysdia", lambda m: True),
    ("cont-cutmix", lambda m: True),
    ("saliency-cutmix", lambda m: True),
    ("latentmixup", lambda m: True),
    ("cutmix", lambda m: "saliency" not in m and "label" not in m),
    ("cutout", lambda m: "saliency" not in m),
    ("s1s2mask", lambda m: m == "s1s2mask"),
]

# 2-D ladder (augmentations2d.py:286-617).
_LADDER_2D = [
    ("durmixcutout", lambda m: True),
    ("durmixtimemask", lambda m: True),
    ("durmixfreqmask", lambda m: True),
    ("durratiomixup", lambda m: True),
    ("cutout", lambda m: "durmixcutout" not in m),
    ("timemask", lambda m: "durmixtimemask" not in m),
    ("freqmask", lambda m: "durmixfreqmask" not in m),
    ("latentmixup", lambda m: True),
    (
        "mixup",
        lambda m: "durratiomixup" not in m and "latentmixup" not in m,
    ),
    ("cutmix", lambda m: "durratiocutmix" not in m),
    ("durratiocutmix", lambda m: True),
]


def _float_after(method: str, prefix: str) -> Optional[Tuple[float, int]]:
    """Parse '(prefix(a,b)' style parameter pairs: returns (a, b) floats/int."""
    parts = method.split(prefix + "(")
    if len(parts) < 2:
        return None
    a = float(parts[1].split(",")[0])
    b = float(parts[1].split(",")[1].split(")")[0])
    return a, b


@dataclasses.dataclass
class MethodSpec:
    raw: str
    base: Optional[str]  # canonical handler name; None = no augmentation
    prob: float = 1.0  # '+p' apply probability (parsed per batch)
    pairing: str = "same_label"
    pairing_param: int = 0  # k for closestknn / bins for closestbins
    alpha: float = 1.0  # beta-distribution alpha for λ
    rand: bool = False  # (rand) random displacement / random cut point
    smooth: bool = False  # (smooth) sigmoid cross-fade at concat joins
    salopt: Optional[str] = None  # 'env' | 'sum'
    salopt_model: int = 0  # 0: base ckpt, 1: durratiomixup ckpt, 2: durmixmagwarp ckpt
    per_channel: bool = False  # (ch)
    params: Tuple[float, ...] = ()  # method-specific numeric params
    selc: bool = False
    class_majority: bool = False
    mix_all_targets: bool = False  # (mixAll): blend one-hot targets by λ
    manifold: bool = False  # manifold-cutmix / manifold-cutout

    @property
    def enabled(self) -> bool:
        return self.base is not None

    @property
    def latent(self) -> bool:
        """Split-forward (latent) method family — latentmixup or any
        manifold-* variant: the mix applies to an intermediate activation
        via a per-depth two-part forward (augmentations.py:1494-1534), and
        the depth/gate draws are seeded by the run's step count."""
        return self.base == "latentmixup" or bool(self.manifold)


def parse_method(method: str, *, spectrogram: bool = False) -> MethodSpec:
    """Parse a method string with the reference's dispatch priority."""
    ladder = _LADDER_2D if spectrogram else _LADDER_1D
    base = None
    for name, guard in ladder:
        if name in method and guard(method):
            base = name
            break

    spec = MethodSpec(raw=method, base=base)
    spec.selc = "SELC" in method
    spec.class_majority = "(class_majority)" in method
    if base is None:
        return spec

    # '+p' apply probability: last '+'-separated token (augmentations.py:933-935).
    parts = method.split("+")
    if len(parts) > 1:
        spec.prob = float(parts[-1])

    # pairing constraints (augmentations.py:943-957).
    if "(sameCVD)" in method:
        spec.pairing = "same_cvd"
    elif "(samePCG)" in method:
        spec.pairing = "same_wav"
    elif "(sameDataset)" in method:
        spec.pairing = "same_dataset"
    elif "(mixAll)" in method:
        spec.pairing = "mix_all"
        spec.mix_all_targets = True
    if "(closestbins=" in method:
        spec.pairing = "closestbins"
        spec.pairing_param = int(method.split("(closestbins=")[1].split(")")[0])
    if "(closestknn=" in method:
        spec.pairing = "closestknn"
        spec.pairing_param = int(method.split("(closestknn=")[1].split(")")[0])

    # per-method pairing overrides.
    if base in ("wav-durratiocutmix",):
        spec.pairing = "same_wav"
    if base == "(UMC-subset)durratiocutmix":
        spec.pairing = "same_umc_subset"
    if base == "lengthcutmix":
        spec.pairing = "same_length"
    if base == "datasetcutmix":
        spec.pairing = "same_dataset"
    if base == "wavcutmix":
        spec.pairing = "same_wav"
    if base in ("swapsysdia", "cont-cutmix", "saliency-cutmix", "cutout"):
        spec.pairing = "mix_all"
    if base == "cutmix":
        # 1-D plain cutmix shuffles across classes (augmentations.py:1521-1522);
        # the 2-D handler pairs within the same label (augmentations2d.py:588)
        spec.pairing = "same_label" if spectrogram else "mix_all"
    if base == "mixup":
        if "(same)" not in method and "(mix)" not in method:
            # both reference handlers only implement these two variants
            # (augmentations.py:841-862, augmentations2d.py:551-572); a bare
            # 'mixup' falls through their dispatchers and crashes — reject it
            # explicitly here
            raise ValueError(
                "mixup requires a '(same)' or '(mix)' variant marker"
            )
        spec.pairing = "same_label" if "(same)" in method else "mix_all"
        spec.mix_all_targets = "(mix)" in method

    # (alpha=…) beta parameter (augmentations.py:958-960, :896-897).
    if "(alpha=" in method:
        spec.alpha = float(method.split("(alpha=")[1].split(")")[0])

    spec.rand = "(rand)" in method
    spec.smooth = "(smooth)" in method
    spec.per_channel = "(ch)" in method
    spec.manifold = "manifold" in method  # augmentations.py:1523-1534, :1579-1590

    # saliency-optimal displacement (augmentations.py:903-913, saliency.py:28-33).
    if "(saloptenv" in method:
        spec.salopt = "env"
    elif "(saloptsum" in method:
        spec.salopt = "sum"
    if spec.salopt is not None:
        tag = method.split("(salopt")[1].split(")")[0]
        if tag.endswith("-1"):
            spec.salopt_model = 1
        elif tag.endswith("-2"):
            spec.salopt_model = 2

    # numeric params after the base-name token.
    if base in ("durmixmagwarp", "magnitudewarp"):
        p = _float_after(method, base)
        spec.params = p if p else (0.2, 4)
    elif base == "timewarp":
        p = _float_after(method, "timewarp")
        spec.params = p if p else (0.05, 2)
    elif base in ("durmixrespscale", "respiratoryscale"):
        p = _float_after(method, base)
        spec.params = (p[0] / 60.0, int(p[1]) / 60.0) if p else (12 / 60, 20 / 60)
    elif base == "gaussiannoise":
        p = _float_after(method, "gaussiannoise")
        spec.params = p if p else (25.0, 40.0)
    elif base in ("timemask", "durmixtimemask"):
        m = re.search(r"timemask\(([\d.]+)\)", method)
        v = min(max(float(m.group(1)), 0.0), 1.0) if m else 0.2
        spec.params = (v,)
    elif base in ("freqmask", "durmixfreqmask"):
        m = re.search(r"freqmask\(([\d.]+)\)", method)
        v = min(max(float(m.group(1)), 0.0), 1.0) if m else 0.2
        spec.params = (v,)
    elif base in ("cutout", "durmixcutout") and spectrogram:
        p = _float_after(method, "cutout")
        spec.params = (
            (min(max(p[0], 0.0), 1.0), min(max(p[1], 0.0), 1.0)) if p else (0.2, 0.2)
        )
    elif base == "cutout":
        spec.params = (0.05,)  # cutout_region_max (augmentations.py:1604)
    elif base == "lengthcutmix":
        bins = 0  # 0 = batch_size//100 default (augmentations.py:564)
        if "(5bins)" in method:
            bins = 5
        if "(10bins)" in method:
            bins = 10
        spec.pairing_param = bins

    return spec
