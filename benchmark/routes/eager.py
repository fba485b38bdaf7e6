"""The eager route: one step a dispatch, the body of the port's training
loop for a method that needs no model hooks (``pcgmix_tpu_torch/train/
loop.py::_train``): the loader's next batch → ``AugmentEngine.plan`` →
``TrainStep.__call__`` (the uploads, the engine's apply with the mix
kernel, forward, loss, backward, clip, Adam, OneCycle), the loss,
predictions and targets kept as the loop keeps them.

A route is found by the traffic's ``route`` and owns the dispatch: the
harness calls ``prepare`` once on the built state (after any planted
fault), ``first_steps`` for the steps the reference follows, then
``step`` for each dispatch, which may train several steps; each step
appends its loss to ``st.losses`` and advances ``st.step_count``, and a
dispatch leaves its plans in ``st.last_plans``."""

from __future__ import annotations

import time

import numpy as np

from benchmark.trace import span


def prepare(st) -> None:
    """Check that the state is built for one step a dispatch."""
    if st.cfg.steps_per_dispatch != 1:
        raise ValueError(f"the eager route trains one step a dispatch, not "
                         f"{st.cfg.steps_per_dispatch}")


def step(st, spans: dict = None, profiled: bool = False) -> None:
    """One dispatch (one step).  ``spans``: host seconds of the plan and of
    the step's call are appended there; ``profiled``: the benchmark's spans
    go into the profiler's trace."""
    t0 = time.perf_counter()
    with span("bench.plan", profiled):
        batch = st.next_batch(profiled)
        plan = None
        if st.engine.enabled:
            plan = st.engine.plan(st.step_count, batch["frames"], batch["label"], batch["wav"])
    t1 = time.perf_counter()
    st.last_batch, st.last_plan = batch, plan
    st.last_plans = [plan.arrays] if plan is not None else []
    with span("bench.step", profiled):
        st.lr_per_step.append(float(st.sched.get_last_lr()[0]))
        out = st.step(batch["indices"], plan.arrays if plan else None, st.epoch,
                      plan.latent_depth if plan else None)
    t2 = time.perf_counter()
    st.losses.append(out["loss"].reshape(1))
    st.preds.append(out["preds"])
    st.targets.append(out["target"])
    st.step_count += 1
    if spans is not None:
        spans["plan"].append(t1 - t0)
        spans["step"].append(t2 - t1)


def first_steps(st, n: int) -> dict:
    """Train the first ``n`` steps, recording what the reference is held
    to: each step's batch rows and plan, the batch the model took (the mix
    kernel's output), the loss, and after the first step Adam's first
    moments ({parameter name: tensor})."""
    taken = []
    hook = st.model.register_forward_pre_hook(
        lambda module, args: taken.append(args[0].detach().float().cpu().numpy()))
    rec = {"plans": [], "mixed": [], "losses": [], "exp_avg": None}
    try:
        for k in range(n):
            step(st)
            plan = {key: np.array(v) for key, v in (st.last_plan.arrays if st.last_plan else {}).items()}
            plan["indices"] = np.array(st.last_batch["indices"])
            rec["plans"].append(plan)
            rec["losses"].append(float(st.losses[-1]))
            if taken:
                rec["mixed"].append(taken.pop())
            if k == 0:
                rec["exp_avg"] = {name: st.opt.state[p]["exp_avg"].detach().double().clone()
                                  for name, p in st.model.named_parameters()
                                  if "exp_avg" in st.opt.state.get(p, {})}
    finally:
        hook.remove()
    return rec
