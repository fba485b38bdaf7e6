"""Augmentation engine: per-step host plans + a device apply
(counterpart: ``pcgmix_tpu/augment/engine.py``).

- ``plan(step, frames, labels, wavs)`` runs on the host in O(batch) scalar
  work and reproduces the reference's step-seeded RNG protocol bit-exactly.
  It returns a :class:`Plan` whose ``arrays`` are a few KB of numpy —
  partner indices, per-segment piece windows, λ, spline knots — equal to
  the JAX engine's, or None when the ``+p`` gate leaves the batch alone.
- ``apply(data, target_ohe, arrays)`` uploads the plan and rewrites the
  device batch through the mix kernels: K1 (``piecewise_mix_batch``, K1
  without a row index) for PCGmix, K2 (``pcgmix_plus_fused``) for PCGmix+.
- ``apply_prepaired(d1, d2, target1, target2, arrays)`` is the data-parallel
  counterpart (JAX ``engine.py:877-953``): a rank passes its block of the
  batch, its partners' rows gathered beforehand and its block of the plan,
  and the rows go through K3 (``piecewise_mix_prepaired``) or K4
  (``pcgmix_plus_fused_prepaired``).

This slice ports the keep-duration blend bases of the main path,
``durratiomixup`` and ``durmixmagwarp``, with same-label pairing and the
``(rand)``, ``(alpha=…)`` and ``+p`` modifiers; other bases raise.
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
from pcgmix_tpu_torch.ops.piecewise import segment_blend_pieces

PORTED_BASES = ("durratiomixup", "durmixmagwarp")
_INT_KEYS = ("mix", "dst", "src", "len", "sel")
_FLOAT_KEYS = ("alpha", "knots")


@dataclasses.dataclass
class AugmentConfig:
    method: str
    batch_size: int
    num_channels: int
    sig_len: int


@dataclasses.dataclass
class Plan:
    arrays: dict


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


class AugmentEngine:
    """One engine per (method, dataset geometry).  See module docstring."""

    def __init__(self, cfg: AugmentConfig):
        self.cfg = cfg
        self.spec: MethodSpec = parse_method(cfg.method)
        spec = self.spec
        if spec.enabled and (
            spec.base not in PORTED_BASES
            or spec.pairing != "same_label"
            or spec.salopt is not None
        ):
            raise NotImplementedError(
                f"method {cfg.method!r} is not ported yet; this slice covers "
                f"{', '.join(PORTED_BASES)} with same-label pairing"
            )
        # Mirror of the reference's ambient NumPy stream, seeded once per run
        # with seed_fix=4.  The ported bases reseed per step and never draw
        # from it; it is kept so plans and RNG state stay equal to the JAX
        # engine's as more bases arrive.
        self.np_stream = np.random.RandomState(4)
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
        frames = np.asarray(frames, np.int64)
        labels = np.asarray(labels)
        mix = pairing_mod.build_pairing(spec, step, labels)
        return self._plan_keepdur_blend(step, frames, labels, mix)

    def _plan_keepdur_blend(self, step, frames, labels, mix):
        spec, cfg = self.spec, self.cfg
        knots = None
        if spec.base == "durmixmagwarp":
            sigma, knot = spec.params[0], int(spec.params[1])
            lam, knots = prng.np_lambda_then_magwarp_knots(
                spec.alpha, step, len(labels), knot, cfg.num_channels, sigma
            )
        else:
            lam = prng.np_beta_lambda(spec.alpha, step)
        nseg = frames.shape[1] - 1  # 4 (zero-pad variant) or 27 (multi-cycle)
        disp = np.zeros((len(labels), nseg), np.int64)
        if spec.rand:
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
        return Plan(arrays=arrays)

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
        """Rewrite a plan's arrays so apply() is the identity."""
        out = {
            k: np.array(v, copy=True) if isinstance(v, np.ndarray) else v
            for k, v in arrays.items()
        }
        out["mix"] = np.arange(batch, dtype=np.int64)
        out["len"][:] = 0
        out["lam"] = np.float32(1.0)
        if "knots" in out:
            out["knots"] = np.ones_like(out["knots"])
        return out

    # ------------------------------------------------------------------ #
    # device: apply
    # ------------------------------------------------------------------ #
    @staticmethod
    def device_arrays(arrays: dict, device) -> dict:
        """Upload a plan's arrays: int32 indices/pieces, float32 alpha/knots."""
        out = {}
        for k in _INT_KEYS:
            out[k] = torch.from_numpy(np.ascontiguousarray(arrays[k], np.int32)).to(device)
        for k in _FLOAT_KEYS:
            if k in arrays:
                out[k] = torch.from_numpy(
                    np.ascontiguousarray(arrays[k], np.float32)
                ).to(device)
        out["lam"] = float(arrays["lam"])
        return out

    def _keepdur_apply(self, data, a):
        return piecewise_mix_batch(
            data, a["mix"], a["dst"], a["src"], a["len"], a["sel"], a["alpha"],
            base_is_d1=True,
        )

    def apply(self, data: torch.Tensor, target_ohe: torch.Tensor, arrays: dict):
        """Apply a plan to the device batch; returns (data, target_ohe)."""
        a = self.device_arrays(arrays, data.device)
        if self.spec.base == "durmixmagwarp":
            # one kernel: partner fetch + segment blend + spline warp
            out = pcgmix_plus_fused(
                data, a["mix"], a["dst"], a["src"], a["len"], a["sel"],
                a["alpha"], a["knots"],
            )
        else:
            out = self._keepdur_apply(data, a)
        if self.spec.mix_all_targets:
            target_ohe = _blend_targets(target_ohe, a["mix"], a["lam"])
        return out, target_ohe

    def apply_prepaired(self, d1: torch.Tensor, d2: torch.Tensor,
                        target1: torch.Tensor, target2: torch.Tensor,
                        arrays: dict):
        """Apply a block of a plan to rows whose partners were gathered
        beforehand: row i of ``d1`` mixes with row i of ``d2``, and its
        one-hot target with row i of ``target2``.  ``arrays`` holds the
        block's rows of every batch-leading plan array.  Returns
        (data, target_ohe)."""
        a = self.device_arrays(arrays, d1.device)
        pieces = (a["dst"], a["src"], a["len"], a["sel"], a["alpha"])
        if self.spec.base == "durmixmagwarp":
            out = pcgmix_plus_fused_prepaired(d1, d2, *pieces, a["knots"])
        else:
            out = piecewise_mix_prepaired(d1, d2, *pieces, base_is_d1=True)
        if self.spec.mix_all_targets:
            target1 = _lerp_targets(target1, target2, a["lam"])
        return out, target1
