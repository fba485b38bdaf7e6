"""The graph route: K steps a dispatch through ``train/steps.py::MultiStep``,
as the port's training loop runs them at ``steps_per_dispatch`` K > 1
(``pcgmix_tpu_torch/train/loop.py::_train``): K batches from the loader,
each planned by ``AugmentEngine.plan_arrays_or_identity`` and
``gated_arrays``, then ``MultiStep.run`` on the chunk.  On a card a full
chunk is one replay of a captured CUDA graph of the K steps (the first
chunk warms up, captures and replays); an epoch's last chunk of fewer than
K steps runs as eager steps, as the loop runs it.  On the CPU every chunk
runs as eager steps.

The route takes K from the traffic's ``steps_per_dispatch``.  Each step
appends its loss to ``st.losses`` and advances ``st.step_count``; a
dispatch leaves its K plans in ``st.last_plans`` and its host times in the
harness's spans as K per-step values."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.trace import span


def prepare(st) -> None:
    """Build the state's ``MultiStep`` of ``steps_per_dispatch`` steps."""
    from pcgmix_tpu_torch.train.steps import MultiStep

    st.multi = MultiStep(st.step, st.cfg.steps_per_dispatch)


def _dispatch(st, profiled: bool) -> tuple:
    """One chunk: plan it, train it, keep what the harness reads; returns
    (batches, plan arrays, the chunk's outputs, host seconds planning, host
    seconds in the run)."""
    per_epoch = st.num_steps // st.cfg.num_epochs
    r = min(st.multi.k, per_epoch - st.step_count % per_epoch)
    t0 = time.perf_counter()
    batches, plans = [], []
    with span("bench.plan", profiled):
        for j in range(r):
            batch = st.next_batch(profiled)
            arrays = {}
            if st.engine.enabled:
                arrays, plan = st.engine.plan_arrays_or_identity(
                    st.step_count + j, batch["frames"], batch["label"], batch["wav"])
                arrays = st.engine.gated_arrays(arrays, plan)
            batches.append(batch)
            plans.append(arrays)
    t1 = time.perf_counter()
    with span("bench.step", profiled):
        out = st.multi.run([(b["indices"], a) for b, a in zip(batches, plans)], st.epoch)
    t2 = time.perf_counter()
    st.last_plans = plans
    st.lr_per_step.extend(out["lr"])
    st.losses.extend(out["loss"].split(1))
    st.preds.append(out["preds"])
    st.targets.append(out["target"])
    st.step_count += r
    return batches, plans, out, t1 - t0, t2 - t1


def step(st, spans: dict = None, profiled: bool = False) -> None:
    """One dispatch: a chunk of K steps, fewer at an epoch's end.
    ``spans``: host seconds a step of the plan and of the chunk's run are
    appended there, once for each step; ``profiled``: the benchmark's spans
    go into the profiler's trace."""
    batches, _, _, plan_s, run_s = _dispatch(st, profiled)
    if spans is not None:
        r = len(batches)
        spans["plan"].extend([plan_s / r] * r)
        spans["step"].extend([run_s / r] * r)


def first_steps(st, n: int) -> dict:
    """Train the first dispatch, ``n`` = K steps (on a card the chunk's
    warm-up, its capture and its first replay), recording what the
    reference is held to: each step's batch rows and plan, and the losses
    and (in the harness) the change that the replay left.  The batch the
    model took (the mix kernel's output) and Adam's first moments after the
    first step ({parameter name: tensor}) are read where Python runs
    between the steps: in the warm-up on a card, which trains the same
    staged chunk eagerly through the same calls before its effects are
    undone, and in the eager steps on the CPU; nothing is read while the
    graph is captured."""
    if n != st.multi.k:
        raise ValueError(f"the graph route checks its first dispatch, {st.multi.k} steps, "
                         f"not {n}")
    taken, moments = [], []

    def read(module, args):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        if len(taken) == 1:  # the second step's forward: the first update is done
            moments.append({name: st.opt.state[p]["exp_avg"].detach().double().clone()
                            for name, p in st.model.named_parameters()
                            if "exp_avg" in st.opt.state.get(p, {})})
        taken.append(args[0].detach().float().cpu().numpy())

    hook = st.model.register_forward_pre_hook(read)
    try:
        batches, plans, out, _, _ = _dispatch(st, False)
    finally:
        hook.remove()
    rec = {"plans": [], "mixed": taken[:n], "losses": [float(x) for x in out["loss"]],
           "exp_avg": moments[0] if moments else None}
    for batch, arrays in zip(batches, plans):
        plan = {key: np.array(v) for key, v in arrays.items()}
        plan["indices"] = np.array(batch["indices"])
        rec["plans"].append(plan)
    return rec
