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
  device batch: the keep-duration blends through the mix kernels, K1
  (``piecewise_mix_batch``, K1 without a row index) for PCGmix,
  ``durmixrespscale`` and the spectrogram ``durmix*mask`` blends, K2
  (``pcgmix_plus_fused``) for PCGmix+; the other bases in plain tensor
  code, as the JAX package computes them in XLA outside any Pallas kernel
  (whole-signal and latent mixup, masks, warps, the respiratory sinusoid,
  Gaussian noise).  For latentmixup and the manifold methods the trainer
  calls it on the latent of the split forward (``train/steps.py``).
- ``apply_prepaired(d1, d2, target1, target2, arrays)`` is the data-parallel
  counterpart for the keep-duration blends (JAX ``engine.py:877-953``): a
  rank passes its block of the batch, its partners' rows gathered
  beforehand and its block of the plan, and the rows go through K3
  (``piecewise_mix_prepaired``) or K4 (``pcgmix_plus_fused_prepaired``).

Spectrograms (``AugmentConfig.spectrogram``; batches (B, 1, F, T)) parse
methods with the 2-D ladder.  Their keep-duration blends run on the
(B, F, T) view, the frequency rows taking the place of channels (JAX
``engine.py:963-970``), with no random displacements; the masks are a
time window per sample, a frequency band shared by the batch, or their
box (``_mask_arrays_2d``).

Ported 1-D bases: ``durratiomixup``, ``durmixmagwarp``, ``durmixrespscale``,
``mixup``, ``latentmixup``, ``timemask``, ``respiratoryscale``,
``magnitudewarp``, ``timewarp``, ``gaussiannoise``, ``cutout`` (with
``(ch)`` and ``manifold-``) and ``s1s2mask``; 2-D bases: ``durratiomixup``,
``durmixfreqmask``, ``durmixtimemask``, ``durmixcutout``, ``cutout``,
``timemask``, ``freqmask``, ``mixup`` and ``latentmixup``; with the
``(sameCVD)``, ``(samePCG)``, ``(sameDataset)`` and ``(mixAll)`` pairings
and the ``(rand)``, ``(alpha=…)`` and ``+p`` modifiers.  Other bases and
pairings raise, naming the ROADMAP item they wait for.

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
from typing import Optional, Sequence

import numpy as np
import torch

from pcgmix_tpu_torch import rng as prng
from pcgmix_tpu_torch.augment import pairing as pairing_mod
from pcgmix_tpu_torch.augment.methods import MethodSpec, parse_method
from pcgmix_tpu_torch.ops.mix_kernels import (
    pcgmix_plus_fused,
    pcgmix_plus_fused_prepaired,
    piecewise_mix_batch,
    piecewise_mix_prepaired,
)
from pcgmix_tpu_torch.models.registry import max_latent_depth
from pcgmix_tpu_torch.ops.masks import box_mask, freq_mask, time_mask, zero_after
from pcgmix_tpu_torch.ops.piecewise import segment_blend_pieces
from pcgmix_tpu_torch.ops.spline import magnitude_warp, time_warp

MASKED_BLEND_BASES = ("durmixfreqmask", "durmixtimemask", "durmixcutout")  # 2-D
KEEPDUR_BASES = ("durratiomixup", "durmixmagwarp", "durmixrespscale") + MASKED_BLEND_BASES
PORTED_BASES = KEEPDUR_BASES + (
    "mixup", "latentmixup", "timemask", "freqmask", "respiratoryscale",
    "magnitudewarp", "timewarp", "gaussiannoise", "cutout", "s1s2mask",
)
# base → the ROADMAP queue 1 item that it waits for
_WAITING_BASES = {
    **dict.fromkeys(("cutmix", "durratiocutmix", "(UMC-subset)durratiocutmix",
                     "wav-durratiocutmix", "labelcutmix", "lengthcutmix",
                     "datasetcutmix", "wavcutmix", "swapsysdia", "cont-cutmix"), 5),
    **dict.fromkeys(("lc-nointrusion", "saliency-cutmix"), 10),
}
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


@dataclasses.dataclass
class Plan:
    arrays: dict
    latent_depth: Optional[int] = None  # latent methods: the split depth


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


def _blend(data, mix_idx, lam):
    """Whole-signal mixup: data·λ + data[mix]·(1−λ) (augmentations.py:849)."""
    mixed = data.index_select(0, mix_idx.long())
    lam = torch.tensor(lam, dtype=data.dtype, device=data.device)
    return data * lam + mixed * (1.0 - lam)


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


def _gaussian_noise(data, snr, end, seed: int):
    """data + N(0, 1)·rms/10^(snr/20) per row, zero at/after ``end``
    (augmentations.py:1060-1076); the noise from a generator on the batch's
    device seeded with ``seed``."""
    rms = data.square().mean(dim=(1, 2), keepdim=True).sqrt()
    std = rms / torch.pow(10.0, snr[:, None, None] / 20.0)
    gen = torch.Generator(device=data.device)
    gen.manual_seed(seed)
    noise = torch.randn(data.shape, generator=gen, device=data.device, dtype=data.dtype)
    return zero_after(data + noise * std, end)


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
        if spec.enabled and spec.base in _WAITING_BASES:
            raise NotImplementedError(
                f"method {cfg.method!r} is not ported yet (ROADMAP queue 1 item "
                f"{_WAITING_BASES[spec.base]})"
            )
        if spec.enabled and (
            spec.base not in PORTED_BASES
            or spec.pairing not in pairing_mod.PORTED_PAIRINGS
            or spec.salopt is not None
            or (spec.manifold and spec.base != "cutout")
        ):
            raise NotImplementedError(
                f"method {cfg.method!r} is not ported yet; the port covers the "
                f"bases {', '.join(PORTED_BASES)} (and manifold-cutout) with the "
                f"pairings {', '.join(pairing_mod.PORTED_PAIRINGS)}"
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
        _force: bool = False,
    ) -> Optional[Plan]:
        spec = self.spec
        if not spec.enabled:
            return None
        if not _force and spec.prob < 1.0 and prng.py_uniform(step) >= spec.prob:
            return None
        cfg, base = self.cfg, spec.base
        frames = np.asarray(frames, np.int64)
        labels = np.asarray(labels)
        B = len(labels)

        def pair():
            return pairing_mod.build_pairing(
                spec, step, labels, frames, wavs, cfg.batch_size, cvd_map=cfg.cvd_map
            )

        if base in KEEPDUR_BASES:
            return self._plan_keepdur_blend(step, frames, labels, pair())
        if base == "mixup":
            mix = pair()
            return Plan(arrays={"mix": mix,
                                "lam": np.float32(prng.np_beta_lambda(1.0, step))})
        if base == "latentmixup":
            mix = pairing_mod.same_label(labels, step)
            return Plan(arrays={"mix": mix,
                                "lam": np.float32(prng.np_beta_lambda(1.0, step))},
                        latent_depth=self._latent_depth(step))
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

    def _plan_keepdur_blend(self, step, frames, labels, mix):
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
        if spec.rand and not cfg.spectrogram:
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
        return Plan(arrays=arrays)

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
    def plan_arrays_or_identity(self, step, frames, labels, wavs=None):
        """Like :meth:`plan`, but always returns arrays of the method's fixed
        structure: gated-off steps come back as identity plans.

        Returns (arrays, plan_or_None)."""
        plan = self.plan(step, frames, labels, wavs)
        if plan is not None:
            return plan.arrays, plan
        return self.identity_arrays(step, frames, labels, wavs), None

    def identity_arrays(self, step, frames, labels, wavs=None):
        """A no-op plan with the method's array structure, cached per batch
        size and frames width.  Built under a snapshot of the NumPy mirror
        stream so a gated-off step consumes no RNG.  Read-only."""
        B = len(labels)
        fkey = (B, np.asarray(frames).shape[-1])
        if fkey not in self._identity_cache:
            np_state = self.np_stream.get_state()
            try:
                forced = self.plan(step, frames, labels, wavs, _force=True)
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
        if "mix" in out:
            out["mix"] = np.arange(batch, dtype=np.int64)
        if "len" in out:
            out["len"][:] = 0
        if "lam" in out:
            out["lam"] = np.float32(1.0)
        for k in ("knots", "sinusoid"):
            if k in out:
                out[k] = np.ones_like(out[k])
        for k in ("bb", "bb1", "bb2", "fbb"):
            if k in out:
                out[k] = np.zeros_like(out[k])
        if "snr" in out:
            out["snr"] = np.full_like(out["snr"], 300.0)
        if "end" in out:
            out["end"] = np.full_like(out["end"], T)
        return out

    # ------------------------------------------------------------------ #
    # device: apply
    # ------------------------------------------------------------------ #
    @staticmethod
    def device_arrays(arrays: dict, device) -> dict:
        """Upload a plan's arrays: integer arrays as int32, floating ones as
        float32; λ stays a Python float and the noise seed an int."""
        out = {}
        for k, v in arrays.items():
            if k == "lam":
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

    def apply(self, data: torch.Tensor, target_ohe: torch.Tensor, arrays: dict):
        """Apply a plan to the device batch, or for a latent method to the
        latent at the plan's depth; returns (data, target_ohe)."""
        base = self.spec.base
        a = self.device_arrays(arrays, data.device)
        if self.cfg.spectrogram and base in ("cutout", "timemask", "freqmask"):
            return _mask_2d(data, a), target_ohe
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
        return _gaussian_noise(data, a["snr"], a["end"], a["noise_seed"]), target_ohe

    def check_prepaired(self) -> None:
        """Raise unless :meth:`apply_prepaired` takes this method: the
        data-parallel route splits a batch over the ranks only for the
        keep-duration blends (the latent methods, the masks and the other
        baselines run on a replicated batch, or on one device)."""
        if self.spec.base not in KEEPDUR_BASES:
            raise NotImplementedError(
                f"{self.spec.base!r} on a data-parallel batch split over the "
                "ranks is not ported yet; run it on one device"
            )

    def apply_prepaired(self, d1: torch.Tensor, d2: torch.Tensor,
                        target1: torch.Tensor, target2: torch.Tensor,
                        arrays: dict):
        """Apply a block of a plan to rows whose partners were gathered
        beforehand: row i of ``d1`` mixes with row i of ``d2``, and its
        one-hot target with row i of ``target2``.  ``arrays`` holds the
        block's rows of every batch-leading plan array.  Returns
        (data, target_ohe)."""
        self.check_prepaired()
        a = self.device_arrays(arrays, d1.device)
        pieces = (a["dst"], a["src"], a["len"], a["sel"], a["alpha"])
        if self.spec.base == "durmixmagwarp":
            out = pcgmix_plus_fused_prepaired(d1, d2, *pieces, a["knots"])
        else:
            out = piecewise_mix_prepaired(_as_rows(d1), _as_rows(d2), *pieces,
                                          base_is_d1=True).view(d1.shape)
        if self.spec.base == "durmixrespscale":
            out = out * a["sinusoid"]
        if self.spec.base in MASKED_BLEND_BASES:
            out = _mask_2d(out, a)
        if self.spec.mix_all_targets:
            target1 = _lerp_targets(target1, target2, a["lam"])
        return out, target1
