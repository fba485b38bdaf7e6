"""Augmentation engine: per-step host plans + a device apply
(counterpart: ``pcgmix_tpu/augment/engine.py``).

- ``plan(step, frames, labels, wavs)`` runs on the host in O(batch) scalar
  work and reproduces the reference's step-seeded RNG protocol bit-exactly.
  It returns a :class:`Plan` whose ``arrays`` are a few KB of numpy —
  partner indices, per-segment piece windows, λ, spline knots, mask
  bounds, SNRs — equal to the JAX engine's, or None when the ``+p`` gate
  leaves the batch alone.  A latent method's plan carries ``latent_depth``,
  the depth of the split forward its apply runs at.
- ``apply(data, target_ohe, arrays)`` uploads the plan and rewrites the
  device batch through the mix kernels wherever the JAX package has a
  Pallas kernel: K1 without a row index (``piecewise_mix_batch``, base
  d1) for PCGmix, the keep-duration cut, ``durmixrespscale`` and the
  spectrogram ``durmix*mask`` blends; K1 with explicit rows and a zero
  base (``piecewise_mix_pairs``) for the concat family (the CutMix
  variants, ``swapsysdia``, ``cont-cutmix``, ``manifold-cutmix``); K2
  (``pcgmix_plus_fused``) for PCGmix+.  The other bases run in plain
  tensor code, as the JAX package computes them in XLA outside any Pallas
  kernel (whole-signal and latent mixup, masks, warps, the respiratory
  sinusoid, Gaussian noise, the ``(smooth)`` crossfade of a concat join).
  For latentmixup and the manifold methods the trainer calls it on the
  latent of the split forward (``train/steps.py``).
- Model-in-the-loop methods take the model through callables the trainer
  passes to ``plan`` (JAX ``engine.py:207-216``): ``saliency_fn(mix_model)``
  gives the batch's (B, T) saliency maps under a pretrained checkpoint for
  the ``(salopt…)`` displacement search; ``saliency_bins_fn()`` the live
  model's per-segment saliency bins for ``saliency-cutmix``; ``latent_fn()``
  the batch's latent embeddings for ``(closestknn=…)``/``(closestbins=…)``.
  ``lc-nointrusion`` plans a pool of 4B candidate joins (K1 with ``idx1``
  and a zero base, N = 4B output rows) that the trainer scores with the
  live model and thins with :meth:`AugmentEngine.lc_select`.
- Under data parallelism a rank mixes its block of the global batch (JAX
  ``engine.py:877-953``, GSPMD over the global batch).  A base that reads a
  partner row goes through ``apply_prepaired(d1, d2, target1, target2,
  arrays)``: the rank passes its rows (for a concat join, the rows ``idx1``
  names), its partners' rows gathered beforehand and its block of the plan;
  the keep-duration blends and cut go through K3
  (``piecewise_mix_prepaired``, base d1) or K4
  (``pcgmix_plus_fused_prepaired``), the concat family and the live-model
  joins through K3 with a zero base, ``cutmix(ch)`` through K3 on the
  (N·C, 1, T) view of its rows, and ``mixup``/``latentmixup`` blend in
  tensor code.  The bases that read their own row alone (the masks, the
  warps, the respiratory sinusoid, Gaussian noise) go through ``apply`` on
  the rank's block and its block of the plan; the batch-shared arrays
  (:data:`SHARED_ARRAYS`) pass whole, and ``gaussiannoise``'s noise is the
  global batch's draw, of which the rank keeps its rows
  (``train/steps.py``).

Spectrograms (``AugmentConfig.spectrogram``; batches (B, 1, F, T)) parse
methods with the 2-D ladder.  Their blends, cuts and concat joins run on
the (B, F, T) view, the frequency rows taking the place of channels (JAX
``engine.py:963-970``), with no random displacements; the masks are a
time window per sample, a frequency band shared by the batch, or their
box (``_mask_arrays_2d``).

Ported 1-D bases: ``durratiomixup``, ``durmixmagwarp``, ``durmixrespscale``,
the keep-duration cut (``durratiocutmix``, ``wav-durratiocutmix``,
``(UMC-subset)durratiocutmix``), the concat family (``cutmix`` with
``(ch)``, ``labelcutmix``, ``lengthcutmix``, ``datasetcutmix``,
``wavcutmix``, ``swapsysdia``, ``cont-cutmix``; ``(rand)``, ``(smooth)``
and ``+cutout``), ``mixup``, ``latentmixup``, ``timemask``,
``respiratoryscale``, ``magnitudewarp``, ``timewarp``, ``gaussiannoise``,
``cutout`` (with ``(ch)``), ``s1s2mask``, ``manifold-cutout`` and
``manifold-cutmix``, ``lc-nointrusion`` (with ``+cutout``) and
``saliency-cutmix``; every 2-D base; every pairing, and the ``(rand)``,
``(alpha=…)``, ``(salopt…)`` and ``+p`` modifiers; each on one device and
on a batch split over data-parallel ranks.

One deviation from the JAX engine: ``gaussiannoise`` draws its noise
tensor from ``jax.random`` there, which torch cannot reproduce (as with
dropout).  Here it comes from a ``torch.Generator`` on the batch's device
seeded with ``SEED_FIX·2³² + step`` (:data:`NOISE_SEED_BASE`), a function of
the step alone, so a gated-off step consumes nothing and a rerun on the
same device draws the same noise.  The per-row SNR and the zero-after end
are the JAX plan's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from pcgmix_tpu_torch import rng as prng
from pcgmix_tpu_torch.augment import pairing as pairing_mod
from pcgmix_tpu_torch.augment.methods import MethodSpec, parse_method
from pcgmix_tpu_torch.augment.salopt import salopt_displacements
from pcgmix_tpu_torch.ops.mix_kernels import (
    pcgmix_plus_fused,
    pcgmix_plus_fused_prepaired,
    piecewise_mix_batch,
    piecewise_mix_pairs,
    piecewise_mix_prepaired,
)
from pcgmix_tpu_torch.models.registry import max_latent_depth
from pcgmix_tpu_torch.ops.masks import box_mask, freq_mask, time_mask, zero_after
from pcgmix_tpu_torch.ops.piecewise import segment_blend_pieces
from pcgmix_tpu_torch.ops.spline import magnitude_warp, time_warp
from pcgmix_tpu_torch.timing import timed

MASKED_BLEND_BASES = ("durmixfreqmask", "durmixtimemask", "durmixcutout")  # 2-D
KEEPDUR_BASES = ("durratiomixup", "durmixmagwarp", "durmixrespscale") + MASKED_BLEND_BASES
# the keep-duration cut: systole and diastole copied from the partner
KEEPDUR_CUT_BASES = ("durratiocutmix", "(UMC-subset)durratiocutmix", "wav-durratiocutmix")
# the concat family: pieces of two rows re-joined on a zero base
CONCAT_BASES = ("cutmix", "labelcutmix", "lengthcutmix", "datasetcutmix", "wavcutmix",
                "swapsysdia", "cont-cutmix")
# the concat joins whose plan takes the live model: a candidate pool scored
# by its loss, and bins of its saliency
LIVE_MODEL_BASES = ("lc-nointrusion", "saliency-cutmix")
PORTED_BASES = KEEPDUR_BASES + KEEPDUR_CUT_BASES + CONCAT_BASES + LIVE_MODEL_BASES + (
    "mixup", "latentmixup", "timemask", "freqmask", "respiratoryscale",
    "magnitudewarp", "timewarp", "gaussiannoise", "cutout", "s1s2mask",
)
LC_MULT = 4  # lc-nointrusion's candidates per batch row (augmentations.py:1230)
# plan arrays that are not batch-leading: a data-parallel rank takes them
# whole (the frequency band is shared by the batch, the sinusoid by its rows)
SHARED_ARRAYS = ("fbb", "sinusoid")
SEED_FIX = 4  # the reference's seed_fix: the mirror stream's seed
NOISE_SEED_BASE = SEED_FIX << 32  # gaussiannoise's generator: + step


@dataclasses.dataclass
class AugmentConfig:
    method: str
    batch_size: int
    num_channels: int
    sig_len: int
    sample_rate: int = 1000
    cvd_map: Optional[dict] = None  # wav → diagnosis, for (sameCVD) pairing
    spectrogram: bool = False  # (B, 1, F, T) batches, the 2-D method ladder
    spec_freq: int = 0  # F, the frequency axis of a spectrogram
    model: str = "resnet9"  # the model name, for latentmixup's depth draw
    num_classes: int = 2  # lc-nointrusion draws its candidates per class


@dataclasses.dataclass
class Plan:
    arrays: dict
    latent_depth: Optional[int] = None  # latent methods: the split depth
    frames_new: Optional[np.ndarray] = None  # concat joins: the new rows' frames
    # the partner of each row and a concat join's cut, as the JAX plan
    # names them (train/counters.py::VariabilityCounter reads them)
    mix_indices: Optional[np.ndarray] = None
    cut: Optional[int] = None
    # lc-nointrusion: the candidates' labels and each class's batch count
    # (for lc_select); saliency-cutmix: its β(1, 1) draw
    aux: dict = dataclasses.field(default_factory=dict)


def _sanitize_padded_pieces(pieces: dict) -> None:
    """Multi-cycle frames padded with −1 give garbage geometry in the padding
    slots; turn those into empty pieces at offset 0."""
    length = np.asarray(pieces["length"])
    bad = length <= 0
    pieces["length"] = np.where(bad, 0, length)
    pieces["dst_start"] = np.where(bad, 0, np.asarray(pieces["dst_start"]))
    pieces["src_start"] = np.where(bad, 0, np.asarray(pieces["src_start"]))


def _blend_targets(target_ohe, mix_idx, lam_t):
    """target·λ + target[mix]·(1−λ), λ a scalar or one per row."""
    return _lerp_targets(target_ohe, target_ohe.index_select(0, mix_idx.long()), lam_t)


def _lerp_targets(target_ohe, partner_ohe, lam_t):
    """target·λ + partner·(1−λ), λ a scalar or one per row."""
    lam_t = torch.as_tensor(lam_t, dtype=target_ohe.dtype, device=target_ohe.device)
    if lam_t.dim() == 0:
        lam_t = lam_t[None]
    if lam_t.dim() == 1:
        lam_t = lam_t[:, None]
    return target_ohe * lam_t + partner_ohe * (1.0 - lam_t)


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A scalar as it is; a vector of one value per row of ``like`` shaped
    to broadcast over its other axes (a gang's rows, ``train/gang.py``)."""
    return x if x.dim() == 0 else x.view(-1, *(1,) * (like.dim() - 1))


def _blend(data, mix_idx, lam):
    """Whole-signal mixup: data·λ + data[mix]·(1−λ) (augmentations.py:849)."""
    return _lerp_rows(data, data.index_select(0, mix_idx.long()), lam)


def _lerp_rows(d1, d2, lam):
    """d1·λ + d2·(1−λ), λ a scalar or one per row."""
    lam = _per_row(torch.as_tensor(lam, dtype=d1.dtype, device=d1.device), d1)
    return d1 * lam + d2 * (1.0 - lam)


def _smooth_join(out, x1, x2, a):
    """The ``(smooth)`` crossfade at a concat join (JAX ``engine.py:136-151``;
    reference augmentations.py:41-51): on [c1−ov, c1+ov) the output is
    x1·(1−w) + x2[clamp(t−c1+c2)]·w, w a logistic ramp over [−8, 8] forced
    to 0 at the window's first step and 1 at its last.  Rows (N, C, T)."""
    T = out.shape[-1]
    t = torch.arange(T, dtype=torch.int64, device=out.device)
    c1, c2, ov = (a[k].long()[:, None] for k in ("c1", "c2", "ov"))
    j = (t - (c1 - ov)).float()
    w2 = torch.sigmoid(-8.0 + 16.0 * j / torch.clamp(2 * ov - 1, min=1).float())
    w2 = torch.where(j <= 0, 0.0, w2)
    w2 = torch.where(j >= 2 * ov - 1, 1.0, w2)[:, None, :]
    inwin = ((t >= c1 - ov) & (t < c1 + ov) & (ov > 0))[:, None, :]
    idx = (t - c1 + c2).clamp(0, T - 1)[:, None, :].expand_as(x2)
    blended = x1 * (1.0 - w2) + torch.gather(x2, 2, idx) * w2
    return torch.where(inwin, blended, out)


def _cutmix_per_channel(d1, d2, a):
    """cutmix(ch) on rows and their partners (JAX ``engine.py:531-548``):
    channel c of row i keeps d1 before its cut ``ch_c1``, takes d2 from
    ``ch_c2`` on up to ``ch_last`` and is zero after: K3 with base d1 and
    one piece on the (N·C, 1, T) view, then the zero tail."""
    N, C, T = d1.shape
    c1, c2 = a["ch_c1"].reshape(-1, 1), a["ch_c2"].reshape(-1, 1)
    last = a["ch_last"].reshape(-1, 1)
    out = piecewise_mix_prepaired(
        d1.reshape(N * C, 1, T), d2.reshape(N * C, 1, T), c1, c2, last - c1,
        torch.ones_like(c1), torch.zeros(c1.shape, dtype=torch.float32, device=d1.device),
        base_is_d1=True,
    )
    return zero_after(out, last.reshape(-1)).view(N, C, T)


def _mask_bb(data, bb):
    """Zero data[..., bb0:bb1) per sample; bb (B, 2), or (B, C, 2) per channel."""
    return time_mask(data, bb[..., 0], bb[..., 1])


def _as_rows(x):
    """The (B, C, T) rows the mix kernels take: a spectrogram (B, 1, F, T)
    as its (B, F, T) view, the frequency rows as channels."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _mask_2d(data, a):
    """Spectrogram masks (JAX ``engine.py:1056-1076``): the time window
    ``bb`` per sample, the frequency band ``fbb`` shared by the batch, or
    with both their box."""
    bb, fbb = a.get("bb"), a.get("fbb")
    if bb is not None and fbb is not None:
        return box_mask(data, bb[:, 0], bb[:, 1], fbb[0], fbb[1])
    if bb is not None:
        return _mask_bb(data, bb)
    if fbb is not None:
        return freq_mask(data, fbb[0], fbb[1])
    return data


def gaussian_noise_draw(seed: int, shape, device, dtype=torch.float32) -> torch.Tensor:
    """The N(0, 1) noise of a ``gaussiannoise`` step: from a generator on
    ``device`` seeded with the plan's ``noise_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype)


def _gaussian_noise(data, snr, end, noise):
    """data + N(0, 1)·rms/10^(snr/20) per row, zero at/after ``end``
    (augmentations.py:1060-1076); ``noise`` is the step's draw, or the seed
    to draw it from (:func:`gaussian_noise_draw`)."""
    rms = data.square().mean(dim=(1, 2), keepdim=True).sqrt()
    std = rms / torch.pow(10.0, snr[:, None, None] / 20.0)
    if not isinstance(noise, torch.Tensor):
        noise = gaussian_noise_draw(noise, data.shape, data.device, data.dtype)
    return zero_after(data + noise * std, end)


def model_in_the_loop(spec: MethodSpec) -> bool:
    """True when the method's plan takes a model: a pretrained checkpoint's
    saliency (``(salopt…)``), a frozen embedder's latents (``(closest…)``),
    or the live model's saliency or candidate losses."""
    return spec.enabled and (spec.salopt is not None
                             or spec.pairing in pairing_mod.LATENT_PAIRINGS
                             or spec.base in LIVE_MODEL_BASES)


def frames_end(frames: np.ndarray) -> np.ndarray:
    """Last valid segment boundary per row (the row max: frames[:, -1] for
    the zero-pad variant, the last non-padding entry for −1-padded
    multi-cycle frames)."""
    return np.asarray(frames).max(axis=-1)


class AugmentEngine:
    """One engine per (method, dataset geometry).  See module docstring."""

    def __init__(self, cfg: AugmentConfig):
        self.cfg = cfg
        self.spec: MethodSpec = parse_method(cfg.method, spectrogram=cfg.spectrogram)
        spec = self.spec
        if spec.enabled and (
            spec.base not in PORTED_BASES
            or spec.pairing not in pairing_mod.PORTED_PAIRINGS
            or (spec.manifold and spec.base not in ("cutout", "cutmix"))
        ):
            raise NotImplementedError(
                f"method {cfg.method!r} is not ported yet; the port covers the "
                f"bases {', '.join(PORTED_BASES)} (and manifold-cutout, "
                f"manifold-cutmix) with the pairings "
                f"{', '.join(pairing_mod.PORTED_PAIRINGS)}"
            )
        # Mirror of the reference's ambient NumPy stream, seeded once per run
        # with seed_fix (train_model.py:222): magnitudewarp, timewarp and
        # gaussiannoise's SNR draw from it without reseeding, so their plans
        # equal the JAX engine's only while every draw comes in its order.
        self.np_stream = np.random.RandomState(SEED_FIX)
        self._identity_cache: dict = {}

    @property
    def enabled(self) -> bool:
        return self.spec.enabled

    # what the trainer wires into plan() (JAX ``engine.py:191-205``)
    @property
    def needs_pretrained_saliency(self) -> bool:
        return self.spec.salopt is not None

    @property
    def needs_latent_model(self) -> bool:
        return self.spec.pairing in pairing_mod.LATENT_PAIRINGS

    @property
    def needs_training_model(self) -> bool:
        return (self.spec.base in LIVE_MODEL_BASES + ("latentmixup",)
                or self.spec.manifold)

    @property
    def model_in_the_loop(self) -> bool:
        return model_in_the_loop(self.spec)

    # ------------------------------------------------------------------ #
    # host: plan
    # ------------------------------------------------------------------ #
    def plan(
        self,
        step: int,
        frames: np.ndarray,
        labels: np.ndarray,
        wavs: Optional[Sequence[str]] = None,
        *,
        latent_fn: Optional[Callable] = None,
        saliency_fn: Optional[Callable] = None,
        saliency_bins_fn: Optional[Callable] = None,
        _force: bool = False,
    ) -> Optional[Plan]:
        """The step's plan, or None when the ``+p`` gate leaves the batch
        alone.  ``latent_fn()``, ``saliency_fn(mix_model)`` and
        ``saliency_bins_fn()`` give the model-in-the-loop methods their
        latents, pretrained saliency maps and live saliency bins; each is
        called only by the methods that need it."""
        spec = self.spec
        if not spec.enabled:
            return None
        if not _force and spec.prob < 1.0 and prng.py_uniform(step) >= spec.prob:
            return None
        cfg, base = self.cfg, spec.base
        frames = np.asarray(frames, np.int64)
        labels = np.asarray(labels)
        B = len(labels)
        if frames.shape[1] != 5 and base in CONCAT_BASES + LIVE_MODEL_BASES:
            # a concat join rewrites the frames vector, which −1-padded
            # multi-cycle frames leave undefined (the reference too)
            raise NotImplementedError(
                f"{base!r} supports single-cycle (5-entry) frames only; "
                "the full multi-cycle variant supports the keep-duration "
                "families, masks, warps, and whole-signal mixes"
            )

        def pair():
            return pairing_mod.build_pairing(
                spec, step, labels, frames, wavs, cfg.batch_size, cvd_map=cfg.cvd_map,
                latent_fn=latent_fn,
            )

        if base in KEEPDUR_BASES:
            return self._plan_keepdur_blend(step, frames, labels, pair(), saliency_fn)
        if base in KEEPDUR_CUT_BASES:
            return self._plan_keepdur_cut(step, frames, pair())
        if base in ("cutmix", "labelcutmix", "lengthcutmix", "datasetcutmix", "wavcutmix"):
            if base == "cutmix" and spec.per_channel:
                p = self._plan_concat_per_channel(step, frames, pair())
            else:
                p = self._plan_concat(step, frames, pair())
            if spec.manifold:
                p.latent_depth = prng.py_randint(step, 0, 3)  # augmentations.py:1527-1530
            return p
        if base == "swapsysdia":
            return self._plan_swapsysdia(step, frames)
        if base == "cont-cutmix":
            return self._plan_cont_cutmix(step, frames)
        if base == "lc-nointrusion":
            return self._plan_lc_nointrusion(step, frames, labels)
        if base == "saliency-cutmix":
            return self._plan_saliency_cutmix(step, frames, saliency_bins_fn)
        if base == "mixup":
            mix = pair()
            return Plan(arrays={"mix": mix,
                                "lam": np.float32(prng.np_beta_lambda(1.0, step))},
                        mix_indices=mix)
        if base == "latentmixup":
            mix = pairing_mod.same_label(labels, step)
            return Plan(arrays={"mix": mix,
                                "lam": np.float32(prng.np_beta_lambda(1.0, step))},
                        latent_depth=self._latent_depth(step), mix_indices=mix)
        if cfg.spectrogram and base in ("cutout", "timemask", "freqmask"):
            return Plan(arrays=self._mask_arrays_2d(step, frames))
        if base == "timemask":
            f1, f2 = prng.py_masked_region(step, spec.params[0])
            end = frames_end(frames)
            bb = np.stack([(f1 * end).astype(np.int64),
                           (f2 * end).astype(np.int64)], axis=1)
            return Plan(arrays={"bb": bb})
        if base == "respiratoryscale":
            rmin, rmax = spec.params
            return Plan(arrays=self._resp_arrays(prng.py_uniform(step), rmin, rmax))
        if base in ("magnitudewarp", "timewarp"):
            sigma, knot = spec.params[0], int(spec.params[1])
            knots = prng.np_magwarp_knots_unseeded(
                self.np_stream, B, knot, cfg.num_channels, sigma
            )
            return Plan(arrays={"knots": knots})
        if base == "gaussiannoise":
            smin, smax = spec.params
            snr = self.np_stream.uniform(smin, smax, size=(B,)).astype(np.float32)
            # zero-after only applies to the zero-pad variant's tail contract
            # (augmentations.py:1076); multi-cycle windows carry real signal
            # to sig_len
            end = (frames_end(frames) if frames.shape[1] == 5
                   else np.full(B, cfg.sig_len, np.int64))
            return Plan(arrays={"snr": snr, "end": end,
                                "noise_seed": np.int64(NOISE_SEED_BASE + step)})
        if base == "cutout":
            return self._plan_cutout_1d(step, frames)
        # s1s2mask
        return Plan(arrays={"bb1": frames[:, 0:2], "bb2": frames[:, 2:4]})

    def _plan_keepdur_blend(self, step, frames, labels, mix, saliency_fn=None):
        spec, cfg = self.spec, self.cfg
        alpha = 1.0 if spec.base == "durmixrespscale" else spec.alpha
        knots = None
        if spec.base == "durmixmagwarp":
            sigma, knot = spec.params[0], int(spec.params[1])
            lam, knots = prng.np_lambda_then_magwarp_knots(
                alpha, step, len(labels), knot, cfg.num_channels, sigma
            )
        else:
            lam = prng.np_beta_lambda(alpha, step)
        nseg = frames.shape[1] - 1  # 4 (zero-pad variant) or 27 (multi-cycle)
        disp = np.zeros((len(labels), nseg), np.int64)
        if spec.salopt is not None:
            # the displacement that maximizes the partners' summed saliency
            # under a pretrained model (JAX ``engine.py:352-359``)
            if nseg != 4:
                raise NotImplementedError(
                    "(salopt…) displacement assumes single-cycle frames; "
                    "use the zero-pad dataset variant"
                )
            sal = saliency_fn(mix_model=spec.salopt_model)
            with timed("salopt search"):
                disp = salopt_displacements(sal, frames, mix, lam, spec.salopt)
        elif spec.rand and not cfg.spectrogram:
            disp = self._rand_displacements(step, frames, mix, segs=range(nseg))
        lam_seg = np.full((len(labels), nseg), lam, np.float32)
        pieces = segment_blend_pieces(frames, frames[mix], disp, lam_seg)
        if nseg > 4:
            _sanitize_padded_pieces(pieces)
        arrays = {
            "mix": mix,
            "dst": pieces["dst_start"],
            "src": pieces["src_start"],
            "len": pieces["length"],
            "sel": pieces["src_sel"],
            "alpha": pieces["alpha"],
            "lam": np.float32(lam),
        }
        if knots is not None:
            arrays["knots"] = knots
        if spec.base == "durmixrespscale":
            rmin, rmax = spec.params
            arrays.update(self._resp_arrays(prng.py_uniform(step), rmin, rmax))
        if spec.base in MASKED_BLEND_BASES:
            arrays.update(self._mask_arrays_2d(step, frames))
        return Plan(arrays=arrays, mix_indices=mix)

    def _plan_keepdur_cut(self, step, frames, mix):
        """The keep-duration cut (JAX ``engine.py:386-414``; reference
        augmentations.py:340-366): systole and diastole (segments ≡ 1, 3
        mod 4, per cycle in the multi-cycle variant) copied from the
        partner with alpha 0, S1 and S2 left as they are; ``(rand)``
        displaces the longer side in 1-D only."""
        B, nseg = frames.shape[0], frames.shape[1] - 1
        swap_segs = tuple(k for k in range(nseg) if k % 4 in (1, 3))
        disp = np.zeros((B, nseg), np.int64)
        if self.spec.rand and not self.cfg.spectrogram:
            disp = self._rand_displacements(step, frames, mix, segs=swap_segs)
        pieces = segment_blend_pieces(frames, frames[mix], disp,
                                      np.zeros((B, nseg), np.float32))
        if nseg > 4:
            _sanitize_padded_pieces(pieces)
        length = np.asarray(pieces["length"]).copy()
        length[:, [k for k in range(nseg) if k % 4 in (0, 2)]] = 0
        return Plan(mix_indices=mix, arrays={
            "mix": mix,
            "dst": pieces["dst_start"],
            "src": pieces["src_start"],
            "len": length,
            "sel": pieces["src_sel"],
            "alpha": pieces["alpha"],
        })

    def _cut_choice(self, step):
        """The segment boundary a concat join cuts at; the seed differs per
        handler (JAX ``engine.py:436-453``): the 1-D plain cutmix always
        draws Random(step·131071).randint(1, 3) (augmentations.py:1549);
        labelcutmix, lc-nointrusion and 2-D cutmix draw that under ``(rand)``
        (:1304, :1248, augmentations2d.py:588-590); length/dataset/wav-cutmix draw
        Random(step) under ``(rand)`` (:1139, :1170, :1201); else 2."""
        spec = self.spec
        if spec.base == "cutmix" and not self.cfg.spectrogram:
            return prng.py_randint(step * 131071, 1, 3)
        if not spec.rand:
            return 2
        if spec.base in ("labelcutmix", "lc-nointrusion") or (
                self.cfg.spectrogram and spec.base == "cutmix"):
            return prng.py_randint(step * 131071, 1, 3)
        return prng.py_randint(step, 1, 3)

    def _concat_piece_arrays(self, frames, mix, cut, idx1=None):
        """Two pieces on a zero base (reference cutmix_multidim_tensors,
        augmentations.py:30-58): d1 (row ``idx1``, default the row itself)
        up to its boundary ``cut`` (c1), then d2 (row ``mix``) from its own
        (c2) on, clipped at T; and the joined row's frames."""
        T = self.cfg.sig_len
        f1 = frames if idx1 is None else frames[idx1]
        f2 = frames[mix]
        N = f1.shape[0]
        c1, c2 = f1[:, cut], f2[:, cut]
        last = np.minimum(c1 + f2[:, -1] - c2, T)
        zeros = np.zeros(N, np.int64)
        arrays = {
            "dst": np.stack([zeros, c1], axis=1),
            "src": np.stack([zeros, c2], axis=1),
            "len": np.stack([c1, last - c1], axis=1),
            "sel": np.stack([zeros, np.ones(N, np.int64)], axis=1),
            "alpha": np.zeros((N, 2), np.float32),
            "last": last, "c1": c1, "c2": c2,
        }
        f_new = np.concatenate(
            [f1[:, : cut + 1], f2[:, cut + 1 :] - c2[:, None] + c1[:, None]], axis=1
        )
        f_new[:, -1] = np.minimum(f_new[:, -1], last)
        return arrays, f_new

    def _plan_concat(self, step, frames, mix):
        """The CutMix variants (JAX ``engine.py:478-509``): the join at
        ``_cut_choice``, with ``ov`` for ``(smooth)``, a cutout window ``bb``
        on the joined row for ``+cutout``, and 1-D cutmix's per-row target
        weight f1[cut]/last (augmentations.py:1560-1565)."""
        spec = self.spec
        cut = self._cut_choice(step)
        arrays, f_new = self._concat_piece_arrays(frames, mix, cut)
        arrays["idx1"] = np.arange(len(mix), dtype=np.int64)
        arrays["idx2"] = mix
        f2 = frames[mix]
        if spec.smooth:
            arrays["ov"] = np.minimum.reduce([
                np.full_like(frames[:, cut], 10), frames[:, cut],
                f2[:, -1] - f2[:, cut], frames[:, -1] - frames[:, cut], f2[:, cut],
            ])
        if "cutout" in spec.raw:
            lo, hi = prng.py_sorted_uniform_pair(step)
            arrays["bb"] = np.stack([(lo * f_new[:, -1]).astype(np.int64),
                                     (hi * f_new[:, -1]).astype(np.int64)], axis=1)
        if spec.base == "cutmix" and not self.cfg.spectrogram:
            arrays["lam_t"] = (frames[:, cut] / np.maximum(arrays["last"], 1)
                               ).astype(np.float32)
        return Plan(arrays=arrays, frames_new=f_new, mix_indices=mix, cut=cut)

    def _plan_concat_per_channel(self, step, frames, mix):
        """cutmix(ch) (JAX ``engine.py:511-529``): a cut per channel from
        Random(step·131071 + c·524287) (augmentations.py:1536-1547); the
        target weight is the mean of the channels' f1[cut]/last."""
        T, C = self.cfg.sig_len, self.cfg.num_channels
        cuts = [prng.py_randint(step * 131071 + c * 524287, 1, 3) for c in range(C)]
        f2 = frames[mix]
        c1, c2 = frames[:, cuts], f2[:, cuts]  # (B, C)
        last = np.minimum(c1 + f2[:, -1:] - c2, T)
        lam_t = (c1 / np.maximum(last, 1)).mean(axis=1).astype(np.float32)
        return Plan(arrays={"idx2": mix, "ch_c1": c1, "ch_c2": c2, "ch_last": last,
                            "lam_t": lam_t}, mix_indices=mix)

    def _plan_swapsysdia(self, step, frames):
        """S1(d1) + systole(d2) + S2(d1) + diastole(d2), re-joined from 0
        (JAX ``engine.py:609-628``; augmentations.py:1335-1353); the target
        weight is d1's share, (s1 + s2)/total."""
        B = frames.shape[0]
        mix = pairing_mod.mix_all(B, step)
        f1, f2 = frames, frames[mix]
        s1, s2 = f1[:, 1] - f1[:, 0], f1[:, 3] - f1[:, 2]
        sys2, dia2 = f2[:, 2] - f2[:, 1], f2[:, 4] - f2[:, 3]
        d0 = np.zeros(B, np.int64)
        return Plan(mix_indices=mix, arrays={
            "idx1": np.arange(B, dtype=np.int64), "idx2": mix,
            "dst": np.stack([d0, s1, s1 + sys2, s1 + sys2 + s2], axis=1),
            "src": np.stack([f1[:, 0], f2[:, 1], f1[:, 2], f2[:, 3]], axis=1),
            "len": np.stack([s1, sys2, s2, dia2], axis=1),
            "sel": np.tile(np.array([0, 1, 0, 1], np.int64), (B, 1)),
            "alpha": np.zeros((B, 4), np.float32),
            "lam_t": ((s1 + s2) / np.maximum(s1 + sys2 + s2 + dia2, 1)).astype(np.float32),
        })

    def _plan_cont_cutmix(self, step, frames):
        """A window of d2 spliced into d1 at the same relative position
        (JAX ``engine.py:630-651``; augmentations.py:1356-1394); one target
        weight for the batch, 1 − (hi − lo)."""
        B = frames.shape[0]
        mix = pairing_mod.mix_all(B, step)
        lo, hi = prng.py_sorted_uniform_pair(step)
        d1_len, d2_len = frames_end(frames), frames_end(frames[mix])
        bb1 = np.stack([(lo * d1_len).astype(np.int64), (hi * d1_len).astype(np.int64)], 1)
        bb2 = np.stack([(lo * d2_len).astype(np.int64), (hi * d2_len).astype(np.int64)], 1)
        seg2 = bb2[:, 1] - bb2[:, 0]
        z = np.zeros(B, np.int64)
        return Plan(mix_indices=mix, arrays={
            "idx1": np.arange(B, dtype=np.int64), "idx2": mix,
            "dst": np.stack([z, bb1[:, 0], bb1[:, 0] + seg2], axis=1),
            "src": np.stack([z, bb2[:, 0], bb1[:, 1]], axis=1),
            "len": np.stack([bb1[:, 0], seg2, d1_len - bb1[:, 1]], axis=1),
            "sel": np.tile(np.array([0, 1, 0], np.int64), (B, 1)),
            "alpha": np.zeros((B, 3), np.float32),
            "lam_t": np.full(B, np.float32(1.0 - (hi - lo)), np.float32),
        })

    def _plan_lc_nointrusion(self, step, frames, labels):
        """The candidate pool of ``lc-nointrusion`` (JAX ``engine.py:550-596``;
        reference augmentations.py:1228-1259): per class, 4n base rows and
        partners drawn with replacement, zipped, shuffled with Random(step)
        and joined at ``_cut_choice``; 4B output rows from a B-row batch."""
        idx_by_class = [[i for i, t in enumerate(labels) if int(t) == c]
                        for c in range(self.cfg.num_classes)]
        n_per_class = [len(ix) for ix in idx_by_class]
        idx1, idx2 = [], []
        for members in idx_by_class:
            drawn1 = random.Random(step * 131071 + 178397654).choices(
                members, k=len(members) * LC_MULT)
            # the reference reassigns label_indices1[i] before it computes
            # the second k, so the partner draw is 16n long, not 4n, and the
            # zip below truncates: every class-1 candidate then takes its
            # partner from class 0's oversized block (cross-class joins).
            # Kept bit for bit, as the JAX package keeps it.
            drawn2 = random.Random(step * 8191 + 99999).choices(
                members, k=len(drawn1) * LC_MULT)
            idx1.append(drawn1)
            idx2.append(drawn2)
        both = list(zip([i for d in idx1 for i in d], [i for d in idx2 for i in d]))
        random.Random(step).shuffle(both)
        idx1 = np.array([p[0] for p in both], np.int64)
        idx2 = np.array([p[1] for p in both], np.int64)
        cut = self._cut_choice(step)
        arrays, f_new = self._concat_piece_arrays(frames, idx2, cut, idx1=idx1)
        arrays["idx1"] = idx1
        arrays["idx2"] = idx2
        if "cutout" in self.spec.raw:
            lo, hi = prng.py_sorted_uniform_pair(step)
            arrays["bb"] = np.stack([(lo * f_new[:, -1]).astype(np.int64),
                                     (hi * f_new[:, -1]).astype(np.int64)], axis=1)
        return Plan(arrays=arrays, frames_new=f_new, mix_indices=idx1, cut=cut,
                    aux={"n_per_class": n_per_class, "cand_labels": labels[idx1]})

    @staticmethod
    def lc_select(losses: np.ndarray, cand_labels: np.ndarray,
                  n_per_class: list) -> np.ndarray:
        """The lowest-loss candidates of each class, as many as the class
        has rows in the batch, in ascending index order (JAX
        ``engine.py:598-607``; augmentations.py:1266-1277)."""
        keep = []
        for c, n in enumerate(n_per_class):
            members = np.where(cand_labels == c)[0]
            order = members[np.argsort(losses[members], kind="stable")]
            keep.extend(order[:n].tolist())
        return np.array(sorted(keep), np.int64)

    def _plan_saliency_cutmix(self, step, frames, saliency_bins_fn):
        """Bin-level saliency splicing (JAX ``engine.py:653-703``; reference
        augmentations.py:1396-1470): of the live model's 14 saliency bins a
        row keeps, in order, the S1 and S2 bins of the more salient partner
        and the systole and diastole bins of its mix_all partner that reach
        the β(1, 1)-drawn rank threshold, else its own; 14 pieces on a zero
        base, packed from 0."""
        B = frames.shape[0]
        mix = pairing_mod.mix_all(B, step)
        bin_values, bin_frames = saliency_bins_fn()
        quasi_lam = prng.np_beta_lambda(1.0, step)
        nbins = bin_values.shape[1]
        dst, src, ln, sel = (np.zeros((B, nbins), np.int64) for _ in range(4))
        lam_t = np.zeros(B, np.float32)
        f_new = np.zeros((B, 5), np.int64)
        thr_idx = min(int(quasi_lam * nbins), nbins - 1)
        for i in range(B):
            bv1, bv2 = bin_values[i], bin_values[mix[i]]
            bf1, bf2 = bin_frames[i], bin_frames[mix[i]]
            thr = np.sort(bv2)[::-1][thr_idx]
            pos = 0
            took = [0, 0]
            for j in range(nbins):
                if j in (0, 5):  # S1 / S2 bins keep the more salient source
                    use2 = not (bv1[j] > bv2[j])
                else:
                    use2 = bv2[j] >= thr
                bf = bf2 if use2 else bf1
                # a bin's start overshoots a short segment (ceil(L/bins)
                # steps a bin), so its raw length can be negative: the
                # placement takes it as empty (the cursor never moves back)
                # while the target weight adds the raw length, as the
                # reference's handler does
                L_raw = int(bf[j + 1] - bf[j])
                L_eff = max(0, L_raw)
                dst[i, j] = pos
                src[i, j] = bf[j]
                ln[i, j] = L_eff
                sel[i, j] = int(use2)
                took[int(use2)] += L_raw
                pos += L_eff
            lam_t[i] = took[0] / max(took[0] + took[1], 1)
            # the new row's frames at its S1/systole/S2/diastole boundaries
            f_new[i] = [0, dst[i, 1], dst[i, 5], dst[i, 6], min(pos, self.cfg.sig_len)]
        arrays = {"idx1": np.arange(B, dtype=np.int64), "idx2": mix,
                  "dst": dst, "src": src, "len": ln, "sel": sel,
                  "alpha": np.zeros((B, nbins), np.float32), "lam_t": lam_t}
        return Plan(arrays=arrays, frames_new=f_new, mix_indices=mix,
                    aux={"quasi_lam": quasi_lam})

    def _plan_cutout_1d(self, step, frames):
        """1-D cutout bounds: one window per row, or with ``(ch)`` one per
        (row, channel) from per-channel seeds (JAX ``engine.py:705-728``);
        ``manifold-cutout`` draws the depth it applies at."""
        B = frames.shape[0]
        end = frames_end(frames)
        depth = prng.py_randint(step, 0, 3) if self.spec.manifold else None
        if self.spec.per_channel:
            C = self.cfg.num_channels
            bb = np.zeros((B, C, 2), np.int64)
            for c in range(C):
                draws = sorted(
                    prng.py_uniform(step + i * 131071 + c * 524287) for i in range(2)
                )
                bb[:, c, 0] = (draws[0] * end).astype(np.int64)
                bb[:, c, 1] = (draws[1] * end).astype(np.int64)
            return Plan(arrays={"bb": bb}, latent_depth=depth)
        lo, hi = prng.py_masked_region(step, self.spec.params[0])
        bb = np.stack([(lo * end).astype(np.int64), (hi * end).astype(np.int64)], axis=1)
        return Plan(arrays={"bb": bb}, latent_depth=depth)

    def _mask_arrays_2d(self, step, frames):
        """Spectrogram mask bounds (JAX ``engine.py:730-753``; reference
        augmentations2d.py:309-325, :449-458, :474-507): a time window per
        sample within the frames' end (``bb``) and a frequency band shared
        by the batch (``fbb``), from two draws seeded off the step."""
        spec, F = self.spec, self.cfg.spec_freq
        u_gap = prng.py_uniform(step + 131071)
        u_pos = prng.py_uniform(step + 13119)
        arrays = {}
        base = spec.base
        if base in ("timemask", "durmixtimemask", "cutout", "durmixcutout"):
            gap = u_gap * spec.params[0]
            t1 = u_pos * (1 - gap)
            t2 = t1 + gap
            end = frames_end(frames)
            arrays["bb"] = np.stack([(t1 * end).astype(np.int64),
                                     (t2 * end).astype(np.int64)], axis=1)
        if base in ("freqmask", "durmixfreqmask", "cutout", "durmixcutout"):
            fmax = spec.params[1] if base in ("cutout", "durmixcutout") else spec.params[0]
            gap = u_gap * fmax
            h1 = int(F * (u_pos * (1 - gap)))
            h2 = min(F, h1 + int(gap * F))
            arrays["fbb"] = np.array([h1, h2], np.int64)
        return arrays

    def _latent_depth(self, step):
        """latentmixup's depth draw (reference augmentations.py:1483-1494):
        fixed for FCN (4) and ResCNN (5), randint(1, max) otherwise."""
        name = self.cfg.model
        if name == "FCN":
            return 4
        if name == "ResCNN":
            return 5
        return prng.py_randint(step, 1, max_latent_depth(name))

    def _resp_arrays(self, u, rmin, rmax):
        """Respiratory sinusoid (augmentations.py:765-773): rate and phase
        from one uniform draw, on a time axis of sig_len samples at the
        sample rate."""
        rate = rmin + u * (rmax - rmin)
        phase = u * 2.0 * np.pi
        T, sr = self.cfg.sig_len, self.cfg.sample_rate
        t = np.linspace(0, T / sr, T)
        return {"sinusoid": np.sin(2 * np.pi * rate * t + phase).astype(np.float32)}

    def _rand_displacements(self, step, frames, mix, segs):
        """(rand) displacement draws: randint(0, |gap|) from a fresh
        Random(step) per segment (reference augmentations.py:305-338).
        Segments invalidated by −1 padding draw nothing."""
        B = frames.shape[0]
        nseg = frames.shape[1] - 1
        disp = np.zeros((B, nseg), np.int64)
        len1 = frames[:, 1:] - frames[:, :-1]
        len2 = frames[mix][:, 1:] - frames[mix][:, :-1]
        gap = np.abs(len2 - len1)
        valid = (len1 > 0) & (len2 > 0) & (frames[:, :-1] >= 0)
        for i in range(B):
            for k in segs:
                if valid[i, k]:
                    disp[i, k] = prng.py_randint(step, 0, int(gap[i, k]))
        return disp

    # ------------------------------------------------------------------ #
    # structure-stable plans (gated-off steps as identity rewrites)
    # ------------------------------------------------------------------ #
    def plan_arrays_or_identity(self, step, frames, labels, wavs=None, **hooks):
        """Like :meth:`plan`, but always returns arrays of the method's fixed
        structure: gated-off steps come back as identity plans.

        Returns (arrays, plan_or_None)."""
        plan = self.plan(step, frames, labels, wavs, **hooks)
        if plan is not None:
            return plan.arrays, plan
        return self.identity_arrays(step, frames, labels, wavs, **hooks), None

    def gated_arrays(self, arrays: dict, plan) -> dict:
        """A chunk's plan arrays (:meth:`plan_arrays_or_identity`) with, for a
        gated (``+p``) method, ``gate``: 1 for the step's plan, 0 for an
        identity plan.  :meth:`apply` keeps the batch as it came where the
        gate is 0: an identity plan's arithmetic alone can move a value by
        an ulp (K2's envelope sums its basis to 1 ± 2e-7), and with the gate
        a step of a chunk equals the single step that applies no plan, bit
        for bit."""
        if self.spec.prob >= 1.0:
            return arrays
        return {**arrays, "gate": np.float32(plan is not None)}

    def identity_arrays(self, step, frames, labels, wavs=None, **hooks):
        """A no-op plan with the method's array structure, cached per batch
        size and frames width.  Built under a snapshot of the NumPy mirror
        stream so a gated-off step consumes no RNG.  Read-only.  Not defined
        for ``lc-nointrusion`` (its plan has 4B rows) and
        ``saliency-cutmix`` (its pieces come from the live model), as in the
        JAX engine."""
        if self.spec.base in LIVE_MODEL_BASES:
            raise NotImplementedError(
                f"identity plans are not defined for {self.spec.base!r}")
        B = len(labels)
        fkey = (B, np.asarray(frames).shape[-1])
        if fkey not in self._identity_cache:
            np_state = self.np_stream.get_state()
            try:
                forced = self.plan(step, frames, labels, wavs, _force=True, **hooks)
            finally:
                self.np_stream.set_state(np_state)
            self._identity_cache[fkey] = self._identity_arrays(forced.arrays, B)
        return self._identity_cache[fkey]

    def _identity_arrays(self, arrays: dict, batch: int) -> dict:
        """Rewrite a plan's arrays so apply() is the identity (Gaussian
        noise: an SNR of 300 dB, whose noise rounds away in float32)."""
        T = self.cfg.sig_len
        out = {
            k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()
        }
        for k in ("mix", "idx1", "idx2"):
            if k in out:
                out[k] = np.arange(batch, dtype=np.int64)
        if "len" in out:
            out["len"][:] = 0
            if self.spec.base in CONCAT_BASES:
                # a concat join starts from zeros: piece 0 copies d1 whole
                for k in ("dst", "src", "sel", "alpha"):
                    out[k][:] = 0
                out["len"][:, 0] = T
        if "lam" in out:
            out["lam"] = np.float32(1.0)
        for k in ("knots", "sinusoid", "lam_t"):
            if k in out:
                out[k] = np.ones_like(out[k])
        for k in ("bb", "bb1", "bb2", "fbb", "ov"):
            if k in out:
                out[k] = np.zeros_like(out[k])
        if "snr" in out:
            out["snr"] = np.full_like(out["snr"], 300.0)
        for k in ("end", "ch_c1", "ch_c2", "ch_last"):
            if k in out:
                out[k] = np.full_like(out[k], T)
        return out

    # ------------------------------------------------------------------ #
    # device: apply
    # ------------------------------------------------------------------ #
    @staticmethod
    def device_arrays(arrays: dict, device) -> dict:
        """Upload a plan's arrays: integer arrays as int32, floating ones as
        float32; λ stays a Python float and the noise seed an int.  Tensors
        pass as they are: a chunk of steps stages its plans on the device
        itself (``train/steps.py::MultiStep``), λ as a 0-d tensor and the
        noise drawn ahead under ``noise``."""
        out = {}
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor):
                out[k] = v
            elif k == "lam" and np.ndim(v) == 0:
                out[k] = float(v)
            elif k == "noise_seed":
                out[k] = int(v)
            else:
                v = np.asarray(v)
                dtype = np.float32 if v.dtype.kind == "f" else np.int32
                out[k] = torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)
        return out

    def _keepdur_apply(self, data, a):
        return piecewise_mix_batch(
            _as_rows(data), a["mix"], a["dst"], a["src"], a["len"], a["sel"],
            a["alpha"], base_is_d1=True,
        ).view(data.shape)

    def _concat_finish(self, out, x1, x2, a):
        """A concat join's mixed rows (N, C, T) after the kernel: the
        ``(smooth)`` crossfade of d1 rows ``x1()`` into d2 rows ``x2()``,
        then the ``+cutout`` window (JAX ``engine.py:1031-1040``)."""
        if self.spec.smooth:
            out = _smooth_join(out, x1(), x2(), a)
        if "bb" in a:
            out = _mask_bb(out, a["bb"])
        return out

    @staticmethod
    def _gated(mixed, data, target_ohe, a: dict):
        """``mixed`` (data, target) where the plan's ``gate`` is on, else the
        batch as it came (see :meth:`gated_arrays`); a gate per row (a
        gang's, whose members gate apart) picks row by row."""
        if "gate" not in a:
            return mixed
        on = torch.as_tensor(a["gate"], device=data.device) > 0
        return (torch.where(_per_row(on, data), mixed[0], data),
                torch.where(_per_row(on, target_ohe), mixed[1], target_ohe))

    def apply(self, data: torch.Tensor, target_ohe: torch.Tensor, arrays: dict):
        """Apply a plan to the device batch, or for a latent method to the
        latent at the plan's depth; returns (data, target_ohe)."""
        a = self.device_arrays(arrays, data.device)
        return self._gated(self._apply(data, target_ohe, a), data, target_ohe, a)

    def _apply(self, data: torch.Tensor, target_ohe: torch.Tensor, a: dict):
        base = self.spec.base
        if self.cfg.spectrogram and base in ("cutout", "timemask", "freqmask"):
            return _mask_2d(data, a), target_ohe
        if base in KEEPDUR_CUT_BASES:
            return self._keepdur_apply(data, a), target_ohe
        if base in CONCAT_BASES + LIVE_MODEL_BASES:
            if self.spec.per_channel:
                out = _cutmix_per_channel(data, data.index_select(0, a["idx2"].long()), a)
            else:
                # N output rows: B, or lc-nointrusion's 4B candidates
                rows = _as_rows(data)
                out = piecewise_mix_pairs(
                    rows, a["idx1"], a["idx2"], a["dst"], a["src"], a["len"], a["sel"],
                    a["alpha"], base_is_d1=False,
                )
                out = self._concat_finish(
                    out, lambda: rows.index_select(0, a["idx1"].long()),
                    lambda: rows.index_select(0, a["idx2"].long()), a,
                ).view(-1, *data.shape[1:])
            if "lam_t" in a:
                target_ohe = _blend_targets(target_ohe, a["idx2"], a["lam_t"])
            elif base == "lc-nointrusion":
                target_ohe = target_ohe.index_select(0, a["idx1"].long())
            return out, target_ohe
        if base in KEEPDUR_BASES or base in ("mixup", "latentmixup"):
            if base == "durmixmagwarp":
                # one kernel: partner fetch + segment blend + spline warp
                out = pcgmix_plus_fused(
                    data, a["mix"], a["dst"], a["src"], a["len"], a["sel"],
                    a["alpha"], a["knots"],
                )
            elif base in ("mixup", "latentmixup"):
                out = _blend(data, a["mix"], a["lam"])
            else:
                out = self._keepdur_apply(data, a)
            if base == "durmixrespscale":
                out = out * a["sinusoid"]
            if base in MASKED_BLEND_BASES:
                out = _mask_2d(out, a)
            if self.spec.mix_all_targets:
                target_ohe = _blend_targets(target_ohe, a["mix"], a["lam"])
            return out, target_ohe
        if base in ("timemask", "cutout"):
            return _mask_bb(data, a["bb"]), target_ohe
        if base == "s1s2mask":
            return _mask_bb(_mask_bb(data, a["bb1"]), a["bb2"]), target_ohe
        if base == "respiratoryscale":
            return data * a["sinusoid"], target_ohe
        if base == "magnitudewarp":
            return magnitude_warp(data, a["knots"]), target_ohe
        if base == "timewarp":
            return time_warp(data, a["knots"]), target_ohe
        # gaussiannoise
        noise = a["noise"] if "noise" in a else a["noise_seed"]
        return _gaussian_noise(data, a["snr"], a["end"], noise), target_ohe

    def apply_prepaired(self, d1: torch.Tensor, d2: torch.Tensor,
                        target1: torch.Tensor, target2: torch.Tensor,
                        arrays: dict):
        """Apply a block of a plan to rows whose partners were gathered
        beforehand: row i of ``d1`` (its base row: ``idx1``'s for the concat
        family) mixes with row i of ``d2``, and its one-hot target with row
        i of ``target2``.  ``arrays`` holds the block's rows of every
        batch-leading plan array.  Returns (data, target_ohe).  The bases
        that read no partner row take :meth:`apply` on the block instead."""
        a = self.device_arrays(arrays, d1.device)
        return self._gated(self._apply_prepaired(d1, d2, target1, target2, a), d1,
                           target1, a)

    def _apply_prepaired(self, d1, d2, target1, target2, a: dict):
        base = self.spec.base
        if base in ("mixup", "latentmixup"):
            out = _lerp_rows(d1, d2, a["lam"])
            if self.spec.mix_all_targets:
                target1 = _lerp_targets(target1, target2, a["lam"])
            return out, target1
        if base in CONCAT_BASES + LIVE_MODEL_BASES:
            if self.spec.per_channel:
                out = _cutmix_per_channel(d1, d2, a)
            else:
                r1, r2 = _as_rows(d1), _as_rows(d2)
                out = piecewise_mix_prepaired(
                    r1, r2, a["dst"], a["src"], a["len"], a["sel"], a["alpha"],
                    base_is_d1=False,
                )
                out = self._concat_finish(out, lambda: r1, lambda: r2, a).view(d1.shape)
            if "lam_t" in a:
                target1 = _lerp_targets(target1, target2, a["lam_t"])
            return out, target1
        pieces = (a["dst"], a["src"], a["len"], a["sel"], a["alpha"])
        if base == "durmixmagwarp":
            out = pcgmix_plus_fused_prepaired(d1, d2, *pieces, a["knots"])
        else:
            out = piecewise_mix_prepaired(_as_rows(d1), _as_rows(d2), *pieces,
                                          base_is_d1=True).view(d1.shape)
        if base == "durmixrespscale":
            out = out * a["sinusoid"]
        if base in MASKED_BLEND_BASES:
            out = _mask_2d(out, a)
        if self.spec.mix_all_targets and base in KEEPDUR_BASES:
            target1 = _lerp_targets(target1, target2, a["lam"])
        return out, target1
