"""Faults planted under the timed path, which the check has to catch: each
is a callable that breaks a built state (:class:`benchmark.harness.Trainer`)
and returns a callable that mends what it patched.  The fault tests plant
them at a small size on the CPU, and ``calibrate.py`` on the card at a
cell's own size, where they give the upper readings of the limits.

- ``frozen``: the optimizer's update does nothing, the eager step's
  (``opt.step``) and the one a CUDA graph replays
  (``ScalarFedUpdate.apply``), so a step returns its state unchanged.
- ``half_batch``: the loss is the mean over the first half of the batch,
  the other half left out.
- ``altered_mix``: the mix kernel's output for the batch's first row is the
  row as it came, unmixed: an answer altered where it is produced.

(The exchange between cards is not a fault a one-card cell can have.)
"""

from __future__ import annotations


def frozen(st):
    from pcgmix_tpu_torch.train import steps

    st.opt.step = lambda *args, **kwargs: None
    original = steps.ScalarFedUpdate.apply  # the update a CUDA graph replays
    steps.ScalarFedUpdate.apply = lambda self, s: None

    def mend():
        steps.ScalarFedUpdate.apply = original
    return mend


def half_batch(st):
    from pcgmix_tpu_torch.train import steps

    original = steps.selc_update

    def halved(soft_labels, logits, target, rows, epoch, es, *args, **kwargs):
        h = logits.shape[0] // 2
        return original(soft_labels, logits[:h], target[:h], rows[:h], epoch, es,
                        *args, **kwargs)

    steps.selc_update = halved

    def mend():
        steps.selc_update = original
    return mend


def altered_mix(st):
    from pcgmix_tpu_torch.augment import engine

    originals = {k: getattr(engine, k) for k in ("pcgmix_plus_fused", "piecewise_mix_batch")}

    def altering(fn):
        def call(data, *args, **kwargs):
            out = fn(data, *args, **kwargs)
            out[0] = data[0]
            return out
        return call

    for k, fn in originals.items():
        setattr(engine, k, altering(fn))

    def mend():
        for k, fn in originals.items():
            setattr(engine, k, fn)
    return mend


FAULTS = {"frozen": frozen, "half_batch": half_batch, "altered_mix": altered_mix}
