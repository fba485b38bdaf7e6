"""One run of one cell: set-up, the measured window, the traced slice, and
the check against the plain reference.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs/<config>.json``) and a traffic mix
(``workloads/<traffic>.json``); the traffic names the route that drives
the program and owns its dispatch (``routes/<route>.py``) and the
kernel launches a step has to make (``launches``), and the cell's limits
are ``limits/<cell>.json``.  Per-layer metrics are read by
``metrics/<metric>.py``.  A configuration's ``family`` names its model
family, ``reference/models/<family>.py``, which gives the reference's
``forward``, the first weights' ``param_specs`` and the operations'
``forward_macs`` (see :mod:`benchmark.reference`): a new model is a
configuration file and a family file.  Every one of these is found by
name, so a later cell, route, model or metric is a file of its own.

Set-up builds the port's training state as ``train_model`` builds it
(``strict_fp32``, ``build_splits``, ``build_model`` + ``seeded_init``,
``make_optimizer``, the ``AugmentEngine``, the ``TrainStep`` over the
corpus on the device through the device cache), loads the benchmark's
first weights into it, trains the first steps through the route (the
numbers the reference is held to) and a few more (warm-up), and hands
that same state to the window.  The window trains until ``--seconds``
have passed, epochs turning over with the loader's reshuffle; it ends in
a ``torch.cuda.synchronize()``.  A traced run then profiles a slice of
further steps.  After the window the peak memory is read, the program's
state is freed, and the reference follows the first steps.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import check, inputs, peaks, trace
from benchmark.reference import common as ref_common
from benchmark.reference import load as ref_load
from benchmark.reference import method_parts

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pcgmix_tpu")  # top-level module names, whole


def _load_file(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "workloads" / f"{w['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", cells)

    return Cell(name, w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def load_limits(cell_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell_name}.json").read_text())["limits"]


def route_module(traffic: dict):
    return _load_file(HERE / "routes" / f"{traffic['route']}.py",
                      f"benchmark_route_{traffic['route']}")


def metric_reader(name: str):
    return _load_file(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Trainer:
    """The port's training state, built as ``train/loop.py::_train`` builds
    it, with the benchmark's first weights loaded into the model.  (A copy
    of ``_train``'s set-up, kept until ``train_model`` can be stopped at a
    deadline and driven whole.)"""

    def __init__(self, cell: Cell, dataset: dict, weights: dict, device,
                 compute_dtype: str = "float32"):
        from pcgmix_tpu_torch.augment.engine import AugmentConfig, AugmentEngine
        from pcgmix_tpu_torch.data.device_cache import device_tensor
        from pcgmix_tpu_torch.models import build_model
        from pcgmix_tpu_torch.ops.filtering import strict_fp32
        from pcgmix_tpu_torch.train.convert import seeded_init
        from pcgmix_tpu_torch.train.losses import init_selc_table
        from pcgmix_tpu_torch.train.loop import TrainConfig, _selc_turnpoint, build_splits
        from pcgmix_tpu_torch.train.steps import TrainStep, make_optimizer

        config, traffic = cell.config, cell.traffic
        recipe = config["recipe"]
        cfg = TrainConfig(
            dataset=config["dataset"], model=config["model"], method=traffic["method"],
            num_epochs=recipe["num_epochs"], batch_size=traffic["batch_size"],
            n_fraction=traffic["n_fraction"], op=recipe["optimizer"],
            lr_max=recipe["lr_max"], grad_clip=recipe["grad_clip"],
            weight_decay=recipe["weight_decay"], seed=traffic["seed"],
            seed_data=traffic["seed_data"], num_classes=config["num_classes"],
            sample_rate=config.get("sample_rate", 1000),
            loader_parity=traffic["loader_parity"], save_artifacts=False, plot=False,
            device=str(device), steps_per_dispatch=traffic["steps_per_dispatch"],
            compute_dtype=compute_dtype,
        )
        self.cfg, self.device = cfg, device
        strict_fp32(device)
        self.train_ds, _ = build_splits(cfg, dataset)
        self.batch = cfg.batch_size
        self.num_steps = cfg.num_epochs * (len(self.train_ds) // cfg.batch_size)
        C, T = self.train_ds.data.shape[1], self.train_ds.data.shape[-1]
        F = self.train_ds.data.shape[-2] if cfg.spectrogram else 0
        model = seeded_init(
            build_model(cfg.model, cfg.num_classes, C, T, seed=cfg.seed, dataset=cfg.dataset,
                        freq=F or None, conv_impl=cfg.conv_impl,
                        compute_dtype=cfg.compute_dtype), cfg.seed_fix)
        model.to(device)
        names = [n for n, _ in model.named_parameters()]
        if sorted(names) != sorted(weights):
            raise ValueError(f"the model's parameters {names} are not the configuration's "
                             f"{sorted(weights)}")
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights[n])
        opt, sched = make_optimizer(model, cfg.op, cfg.lr_max, cfg.weight_decay,
                                    self.num_steps, cfg.use_sched)
        engine = AugmentEngine(AugmentConfig(
            method=cfg.method, batch_size=cfg.batch_size, num_channels=C, sig_len=T,
            sample_rate=cfg.sample_rate, spectrogram=cfg.spectrogram, spec_freq=F,
            model=cfg.model, num_classes=cfg.num_classes))
        self.model, self.opt, self.sched, self.engine = model, opt, sched, engine
        self.step = TrainStep(
            model, opt, sched,
            train_data=device_tensor(self.train_ds.data, device),
            train_labels=device_tensor(self.train_ds.label, device),
            soft_labels=init_selc_table(self.train_ds.label, cfg.num_classes, device),
            num_classes=cfg.num_classes, grad_clip=cfg.grad_clip,
            selc_es=_selc_turnpoint(cfg), engine=engine)
        self.step_count, self.epoch, self._it = 0, 0, None
        self.lr_per_step, self.losses, self.preds, self.targets = [], [], [], []
        self.last_batch = self.last_plan = None
        self.last_plans = []  # the plans of the last dispatch (dicts of arrays)

    def next_batch(self, profiled: bool = False) -> dict:
        """The loader's next batch; at an epoch's end a new epoch, shuffled
        by the loader from the step count, as the loop does."""
        from pcgmix_tpu_torch.data import EpochIterator

        batch = next(self._it, None) if self._it is not None else None
        if batch is None:
            with trace.span("bench.epoch", profiled):
                self.epoch += 1
                self._it = iter(EpochIterator(self.train_ds, self.batch, self.cfg.seed,
                                              self.step_count, self.cfg.loader_parity))
            batch = next(self._it)
        return batch


def observed_record(rec: dict, model, weights_host: dict, recipe: dict,
                    total_steps: int) -> dict:
    """What the program's first steps give, in the reference's terms: the
    first gradient as Adam took it (its first moment over 1 − β₁ of step 0)
    and each leaf's change since the first weights, as norms."""
    beta1 = ref_common.onecycle(recipe, total_steps, 0)[1]
    grad1 = None
    if rec["exp_avg"]:
        grad1 = {k: float(v.norm()) / (1.0 - beta1) for k, v in rec["exp_avg"].items()}
    change = {n: float((p.detach().double().cpu() - weights_host[n].double()).norm())
              for n, p in model.named_parameters()}
    return {"plans": rec["plans"], "mixed": rec["mixed"], "losses": rec["losses"],
            "grad1": grad1, "change": change}


def reference_record(cell: Cell, dataset: dict, weights_host: dict, device,
                     ops: ref_common.Ops) -> dict:
    """The plain reference's first steps: its batch order, plans, mixed
    batches, losses, first gradients and changes."""
    config, traffic = cell.config, cell.traffic
    n_steps, batch = traffic["check_steps"], traffic["batch_size"]
    rows = inputs.train_rows(dataset, config)
    labels, frames = dataset["train"]["label"], dataset["train"]["frames"]
    order = ref_common.epoch_order(len(labels), traffic["seed"], 0)
    base, numbers = method_parts(traffic["method"])
    planner, model = ref_load("plans", base), ref_load("models", config["family"])
    eye = np.eye(config["num_classes"])
    plans, mixed, batches = [], [], []
    for s in range(n_steps):
        idx = order[s * batch:(s + 1) * batch]
        x = torch.from_numpy(rows[idx]).to(device, ops.dtype)
        as_rows = x.reshape(batch, -1, x.shape[-1])  # a spectrogram's (B, F, T) view
        plan = planner.plan(s, frames[idx], labels[idx], numbers, as_rows.shape[1])
        plan["indices"] = idx
        xm = planner.mix(as_rows, plan).reshape(x.shape)
        plans.append(plan)
        mixed.append(xm.detach().double().cpu().numpy())
        batches.append((xm, torch.from_numpy(eye[labels[idx]]).to(device)))
    total = config["recipe"]["num_epochs"] * (len(labels) // batch)
    params0 = {k: v.to(device) for k, v in weights_host.items()}
    traj = ref_common.follow(config["recipe"], total,
                             lambda p, x, o: model.forward(p, x, o, config),
                             params0, batches, ops)
    return {"plans": plans, "mixed": mixed, **traj}


def process_seconds() -> float:
    """Seconds since this process started (Linux's ``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """What a run measured, for the per-layer metric readers."""
    cell: Cell
    peaks: Optional[dict]
    window_s: float
    steps: int
    samples: int
    spans: dict  # "plan"/"step" → host seconds a step in the window
    step_gaps_ms: list  # device ms a step between the window's dispatches (CUDA events)
    trace: Optional[trace.Trace]
    trace_steps: int  # steps in ``trace``
    slice_launches: dict  # kernel wrapper → launches in ``trace``'s slice
    slice_plans: list  # ``trace``'s plans (dicts of arrays)


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device, *,
            compute_dtype: str = "float32", faults=(), clock_offset: float = 0.0,
            limits: Optional[dict] = None) -> dict:
    """One run; returns the result line's object and, under
    ``_observed``/``_reference``/``_values``, the records compared and the
    numbers.  ``clock_offset``: the process's age minus
    ``time.perf_counter()``, so that ``setup_s`` counts from the process's
    start; ``faults``: callables that break the built state and return what
    mends it (:mod:`benchmark.faults`); ``compute_dtype``: the model's
    (bfloat16 for the control); ``limits``: instead of the cell's file."""
    config, traffic = cell.config, cell.traffic
    route = route_module(traffic)
    t = time.perf_counter()
    importlib.import_module("pcgmix_tpu_torch.train.loop")  # the program's imports, timed apart
    log(f"program imports: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    dataset = inputs.make_dataset(config, traffic, seed, device)
    weights = inputs.make_weights(config, seed, device)
    weights_host = {k: v.cpu() for k, v in weights.items()}
    log(f"inputs: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    st = Trainer(cell, dataset, weights, device, compute_dtype)
    del weights
    mends = [fault(st) for fault in faults]
    route.prepare(st)
    log(f"state: {time.perf_counter() - t:.3f} s")
    held = [st]  # _measure frees the state before the reference runs
    del st
    try:
        return _measure(cell, held, route, dataset, weights_host, seconds, traced, device,
                        clock_offset, limits)
    finally:
        for mend in mends:
            mend()


def _measure(cell, held, route, dataset, weights_host, seconds, traced, device,
             clock_offset, limits):
    from pcgmix_tpu_torch.data import device_cache
    from pcgmix_tpu_torch.ops.build import launch_counts

    traffic = cell.traffic
    st = held.pop()
    t = time.perf_counter()
    rec = route.first_steps(st, traffic["check_steps"])
    observed = observed_record(rec, st.model, weights_host, cell.config["recipe"], st.num_steps)
    del rec
    for _ in range(traffic["warmup_steps"]):
        route.step(st)
    sync(device)
    log(f"first and warm-up steps: {time.perf_counter() - t:.3f} s")

    spans = {"plan": [], "step": []}
    events = []  # (a CUDA event after a dispatch, the steps it trained)
    launches0 = launch_counts()
    losses0 = len(st.losses)
    t_start = time.perf_counter()
    setup_s = clock_offset + t_start  # seconds since the process started
    deadline = t_start + seconds
    while time.perf_counter() < deadline and st.step_count < st.num_steps:
        before = st.step_count
        route.step(st, spans if traced else None)
        if traced:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((ev, st.step_count - before))
    sync(device)
    window_s = time.perf_counter() - t_start
    steps = len(st.losses) - losses0
    launches = {k: v - launches0.get(k, 0) for k, v in launch_counts().items()}
    bad = forbidden_modules()
    window_losses = torch.cat(st.losses[losses0:]) if steps else torch.zeros(0)
    failed = int((~torch.isfinite(window_losses)).sum())
    log(f"window: {steps} steps in {window_s:.3f} s; launches {launches}")

    run = None
    if traced:
        gaps = [a.elapsed_time(b) / n for (a, _), (b, n) in zip(events, events[1:])]
        tr, slice_steps, slice_launches, slice_plans = profile_slice(
            st, route, traffic["trace_steps"], traffic["launches"])
        run = Run(cell, peaks.peaks_for(torch.cuda.get_device_name(device)), window_s, steps,
                  steps * st.batch, spans, gaps, tr, slice_steps, slice_launches, slice_plans)
        log(f"device busy {tr.busy_s:.6f} s of a {tr.wall_s:.6f}-s slice of {slice_steps} "
            f"steps; the window's {1e3 * window_s / max(steps, 1):.4f} ms a step against "
            f"{1e3 * tr.busy_s / slice_steps:.4f} ms busy a step")
    on_card = torch.device(device).type == "cuda"
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    del st, window_losses
    device_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()

    out = {"correct": False, "attempted": steps, "failed": failed}
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out["metrics"] = metrics
    else:
        rate = steps * traffic["batch_size"] / window_s
        out["metrics"] = {"train_samples_per_s": {"value": rate, "unit": "samples/s"},
                          "setup_s": {"value": setup_s, "unit": "s"}}
    out["device"] = {"platform": "gpu", "kind": kind, "count": cell.chips,
                     "memory_peak_bytes": memory_peak}
    if traced:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.wall_s
        out["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops(10)],
                            "idle_gaps": [list(x) for x in run.trace.idle_gaps()[:10]]}

    t = time.perf_counter()
    reference = reference_record(cell, dataset, weights_host, device, ref_common.Ops())
    values = check.readings(observed, reference)
    values["launches"] = launch_gap(traffic["launches"], launches, steps, on_card)
    log(f"reference: {time.perf_counter() - t:.3f} s")
    out["_observed"], out["_reference"], out["_values"] = observed, reference, values
    limits = limits if limits is not None else load_limits(cell.name)
    out["correct"] = bool(check.judge(values, limits) and failed == 0 and not bad)
    out["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    out["_forbidden"] = bad
    return out


def launch_gap(expected: dict, launches: dict, steps: int, on_card: bool) -> float:
    """How far the window's launches stray from the traffic's: the sum over
    the port's kernel wrappers of |launches − per step × steps|, a wrapper
    that the traffic does not name being due none.  On the CPU the
    wrappers run their plain versions and launch nothing."""
    due = {k: (v["per_step"] if on_card else 0) * steps for k, v in expected.items()}
    return float(sum(abs(launches.get(k, 0) - due.get(k, 0)) for k in set(due) | set(launches)))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _steps(st, route, n_steps: int, plans: Optional[list] = None, **kw) -> int:
    """Dispatch until ``n_steps`` steps or more have trained; the count."""
    start = st.step_count
    while st.step_count - start < n_steps:
        route.step(st, **kw)
        if plans is not None:
            plans.extend(st.last_plans)
    return st.step_count - start


def profile_slice(st, route, n_steps: int, expected: dict, tries: int = 3):
    """Profile a slice of ``n_steps`` or more further steps with host and
    device activity; a trace that lost events of a kernel that the port
    counted is taken again, up to ``tries`` times.  ``expected``: the
    traffic's ``launches``, which name each wrapper's device kernel.
    Returns (trace, steps, launches in the slice, the slice's plans)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pcgmix_tpu_torch.ops.build import launch_counts

    for attempt in range(tries):
        before = launch_counts()
        plans = []
        sync(st.device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("bench.slice"):
                n = _steps(st, route, n_steps, plans, profiled=True)
                sync(st.device)
        launched = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        tr = trace.read(prof)
        by_kernel = {}
        for wrapper, v in expected.items():
            by_kernel[v["device_kernel"]] = by_kernel.get(v["device_kernel"], 0) + launched[wrapper]
        lost = {k: (tr.kernel_events(k)[1], n_launched) for k, n_launched in by_kernel.items()
                if tr.kernel_events(k)[1] != n_launched}
        if not lost:
            return tr, n, launched, plans
        log(f"traced slice {attempt + 1}: kernel events against launches {lost}; "
            f"profiling again")
    raise RuntimeError(f"the profiler lost kernel events in {tries} slices")


def result_line(out: dict) -> str:
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
    return json.dumps({k: out[k] for k in keys if k in out})
