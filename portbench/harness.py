"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by the name BENCHMARK.json gives it:

  configuration  the file its entry names (portbench/configs/<name>.json)
  traffic mix    portbench/traffic/<traffic>.json, whose "job" names the
                 general driver in portbench/jobs/<job>.py
  per-layer      portbench/metrics/<name>.py: read(obs) -> number or None;
                 optionally SPAN (a portbench/spans/<span>.py to install in
                 traced runs) and snapshot() (a program counter, read before
                 and after the window; obs["delta"] is the difference)

A job module gives setup(ctx) -> state, unit(state, i) -> {counter: n},
release(state), check(state, rng) -> {number: (value, limit)} and
control(state, rng) -> {number: value} (portbench/control.py). The
traffic file's "rates" turn the units' counters into the end-to-end rates:
{metric: {"counter": name, "scale": factor}} = sum of the counter over the
window times factor, over the window's seconds.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "necat_tpu")
# a traced run's window: the profiler's events of a longer one take minutes
# to read
TRACE_SECONDS = 15.0


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_module(path: Path):
    """Import a file by its path (names may hold dots, as metric names do)."""
    name = "portbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its configuration and
    traffic files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(w, config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, workload)],
                [m for m in bench["per_layer"] if _reports(m, workload)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must never
    load (compared whole: necat_tpu_torch is not necat_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@contextlib.contextmanager
def _spans(names, root: Path, accs: dict):
    """Wrap each span's target in a record_function range of its name and
    call its after() hook; restore the targets on exit."""
    import importlib

    import torch
    undo = []
    try:
        for name in names:
            mod = load_module(root / "portbench" / "spans" / f"{name}.py")
            owner = importlib.import_module(mod.TARGET[0])
            fn = getattr(owner, mod.TARGET[1])
            acc = accs.setdefault(name, {})

            def wrapped(*args, _fn=fn, _mod=mod, _acc=acc, _name=name, **kwargs):
                with torch.profiler.record_function(_name):
                    out = _fn(*args, **kwargs)
                _mod.after(_fn, args, kwargs, out, _acc)
                return out

            setattr(owner, mod.TARGET[1], wrapped)
            undo.append((owner, mod.TARGET[1], fn))
        yield
    finally:
        for owner, attr, fn in undo:
            setattr(owner, attr, fn)


def _scopes_as_ranges():
    """Make each of the program's timing scopes a profiler range too, before
    the program's modules bind `timed` (traced runs only)."""
    import torch

    from necat_tpu_torch.utils import logging as plog
    plain = plog.timed

    @contextlib.contextmanager
    def timed(name):
        with torch.profiler.record_function(name), plain(name):
            yield

    plog.timed = timed
    # the scopes' seconds, without the report the program prints at exit
    plog.TIMING_ON = True


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
        device: str = "cuda", t_start: float | None = None, log=sys.stderr) -> dict:
    """One run of a cell: set-up, the window, the check. Returns the result
    object (the last line of a run)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from portbench import inputs
    inputs.START = t_start
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    cell = load_cell(root, workload)
    for k, v in cell.traffic.get("env", {}).items():
        os.environ[k] = str(v)
    if trace:
        _scopes_as_ranges()
    import torch
    job = load_module(root / "portbench" / "jobs" / f"{cell.traffic['job']}.py")
    readers = {m["name"]: load_module(root / "portbench" / "metrics" / f"{m['name']}.py")
               for m in (cell.per_layer if trace else [])}
    ctx = {"config": cell.config, "traffic": cell.traffic, "seed": seed, "device": device,
           "log": log}
    state = job.setup(ctx)
    _sync(device)
    log.write(inputs.stamp("done"))

    span_names = sorted({getattr(r, "SPAN") for r in readers.values() if hasattr(r, "SPAN")})
    accs: dict = {}
    before = {n: r.snapshot() for n, r in readers.items() if hasattr(r, "snapshot")}
    counters: collections.Counter = collections.Counter()
    prof = None
    if trace:
        from necat_tpu_torch.utils import logging as plog
        plog.reset_timers()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    units = 0
    with _spans(span_names if trace else (), root, accs):
        with torch.profiler.record_function("portbench.window"):
            t_open = time.perf_counter()
            unit_ends = []
            while True:
                counters.update(job.unit(state, units))
                units += 1
                unit_ends.append(time.perf_counter() - t_open)
                if unit_ends[-1] >= seconds:
                    break
            _sync(device)
            window_s = time.perf_counter() - t_open
    print("unit_ends_s " + json.dumps([round(x, 3) for x in unit_ends]), file=log)
    obs = {"window_s": window_s}
    if trace:
        prof.__exit__(None, None, None)
        from portbench import trace as tr
        from necat_tpu_torch.utils import logging as plog
        obs["scopes"] = {k: v for k, (v, _) in plog.timing_report(None).items()}
        events = prof.profiler.kineto_results.events()
        win = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
               if e.name() == "portbench.window"]
        red = tr.reduce_events(events, win[0], span_names)
        del events, prof
        obs["busy_s"] = red["busy_s"]
        obs["spans"] = {n: {"device_s": red["span_device_s"][n],
                            "least_s": float(accs.get(n, {}).get("least_s", 0.0)),
                            "calls": accs.get(n, {}).get("calls", 0)} for n in span_names}
    after = {n: r.snapshot() for n, r in readers.items() if hasattr(r, "snapshot")}

    metrics = {}
    if trace:
        for m in cell.per_layer:
            r = readers[m["name"]]
            v = r.read({**obs, "delta": (after[m["name"]] - before[m["name"]])
                        if m["name"] in before else None})
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                continue
            spec = cell.traffic["rates"][m["name"]]
            metrics[m["name"]] = {"value": counters[spec["counter"]] * spec["scale"] / window_s,
                                  "unit": m["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    if device.startswith("cuda"):
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell.workload["chips"]),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace:
        dev["busy_s"] = obs["busy_s"]
        dev["window_s"] = window_s

    # the check: the program's state freed first, the reference after
    job.release(state)
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    rng = np.random.default_rng([seed, 7])
    t_check = time.perf_counter()
    checks = job.check(state, rng)
    print(f"check: {time.perf_counter() - t_check:.1f} s", file=log)
    correct = all(v <= lim for v, lim in checks.values())
    # whatever the window or the reference loaded: no result if it holds
    # JAX or the JAX package
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run: {found}", file=log)
        raise SystemExit(3)
    result = {"correct": bool(correct), "attempted": units, "failed": int(state.get("failed", 0)),
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"{k} {v} limit {lim}", file=log)
    log.flush()
    return result
