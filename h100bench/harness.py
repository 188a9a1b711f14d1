"""The benchmark's driver: one run of one cell.

Everything a cell is comes from files found by name: ``workloads/<cell>.json``
(its configuration, traffic kind, parameters, chips, checked limits),
``configs/<config>.json`` (the deployment's sizes), ``traffic/<kind>.py``
(inputs from the seed, one step, the reference check) and, for each
per-layer metric ``BENCHMARK.json`` lists for the cell,
``layer_metrics/<metric>.py`` (a reader of the traced window).

A run: set-up (inputs, warm-up of every shape the cell uses), then either
the timed window (``--trace 0``: closed loop, each step after the last,
for ``--seconds``) or a profiled window of a fixed number of steps
(``--trace 1``); then the peak memory, the program's state freed, the
reference's judgement of the kept steps, and one JSON line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in the process that reports
FORBIDDEN = ("jax", "jaxlib", "flax", "feos_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str):
    """``(workload spec, configuration, traffic module)`` of a cell, by name."""
    spec = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = json.loads((HERE / "configs" / f"{spec['config']}.json").read_text())
    traffic = load_module(HERE / "traffic" / f"{spec['kind']}.py", f"h100bench_traffic_{spec['kind']}")
    return spec, config, traffic


def forbidden_modules():
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit():
    """The card's power limit as ``nvidia-smi`` prints it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class Trace:
    """What the layer-metric readers read, from two profiled windows of
    ``steps`` steps each: one of the device alone (busy time, kernels and
    their time, over ``window_s``; recording host events would stretch the
    host's part of each step), and one of host and device (aten ops, syncs,
    and what the host was doing in each idle gap).  ``work`` is the cell's
    work a step."""

    def __init__(self, device_prof, host_prof, steps, window_s, work):
        self.steps, self.window_s, self.work = steps, window_s, work
        dev, _ = self._events(device_prof)
        self.device_ops = len(dev)
        self.busy_s, _ = self._busy_and_gaps(dev)
        self.by_kernel = {}
        for s, e, name in dev:
            self.by_kernel[name] = self.by_kernel.get(name, 0) + (e - s)
        hdev, host = self._events(host_prof)
        self.host_ops = sum(name.startswith("aten::") for _, _, name in host)
        self.syncs = sum("Synchronize" in name for _, _, name in host)
        self.idle_by_host = self._attribute(self._busy_and_gaps(hdev)[1], host)

    @staticmethod
    def _events(prof):
        """``(device events, host events)`` as sorted (start, end, name) in ns."""
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (start, start + e.duration_ns(), e.name())
            (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
        dev.sort()
        host.sort()
        return dev, host

    @staticmethod
    def _busy_and_gaps(dev):
        busy, gaps, end = 0, [], None
        for s, e, _ in dev:
            if end is None or s > end:
                if end is not None:
                    gaps.append((end, s))
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9, gaps

    @staticmethod
    def _attribute(gaps, host):
        """Idle device time by what the host was doing: the latest-started
        host event still running at each gap's midpoint (the innermost of
        nested ones), or time between host ops.  One sweep over both."""
        out, stack, k = {}, [], 0
        for s, e in gaps:  # in time order, as the device events were
            mid = (s + e) // 2
            while k < len(host) and host[k][0] <= mid:
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host between ops"
            out[name] = out.get(name, 0) + (e - s)
        return out

    def kernel_seconds(self, names) -> float:
        """Device seconds a step of the kernels of these function ``names``
        (a trace names a kernel by its signature, as in
        ``(anonymous namespace)::pure_vle_solve(double const*, ...)``)."""
        pattern = re.compile(r"(^|::)(%s)[(<]" % "|".join(map(re.escape, names)))
        ns = sum(t for name, t in self.by_kernel.items() if pattern.search(name))
        return ns * 1e-9 / self.steps

    def breakdown(self):
        top = sorted(self.by_kernel.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t * 1e-9] for n, t in top],
                "idle_gaps": [[n, t * 1e-9] for n, t in idle]}


def layer_metrics(bench, cell_name, trace):
    """Each per-layer metric listed for this cell, read by its own reader;
    a reader that finds nothing leaves its metric out."""
    out = {}
    for m in bench["per_layer"]:
        if cell_name not in m.get("workloads", [cell_name]):
            continue
        reader = load_module(HERE / "layer_metrics" / f"{m['name']}.py",
                             "h100bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end_names(bench, cell_name):
    return [m["name"] for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def run(argv, t_start, device=None, params=None):
    """One run; returns ``(exit code, result dict or None)``.  ``device``
    None means the card, checked first; tests pass the CPU, and may shrink
    the cell through ``params`` (merged into the workload's)."""
    import argparse

    ap = argparse.ArgumentParser(prog="h100bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec, config, traffic = load_cell(args.workload)
    spec["params"].update(params or {})
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
            print(f"need {spec['chips']} CUDA device(s); torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cell = traffic.Cell(spec, config, args.seed, device)
    cell.setup()
    sync()
    if device.type == "cuda":
        # the peak from here on is the program's: set-up's reference is freed
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    # warm up with the checked steps kept, as the window keeps them, so that
    # the allocator holds their blocks before the window opens
    cell.begin_window()
    cell.warm_up()
    sync()
    cell.begin_window()

    # a step's results are folded in as it ends: a list of per-step device
    # scalars or events would lift the peak, and the collector's work, with
    # the number of steps
    converged = torch.zeros((), dtype=torch.long, device=device)
    steps, step_s = 0, []
    if not args.trace:
        cuda_events = device.type == "cuda"
        if cuda_events:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        deadline = t0 + args.seconds
        while True:
            ts = time.perf_counter()
            if cuda_events:
                e0.record()
            converged += cell.step()
            if cuda_events:
                e1.record()
            sync()
            t = time.perf_counter()
            step_s.append(e0.elapsed_time(e1) * 1e-3 if cuda_events else t - ts)
            steps += 1
            if t >= deadline:
                break
        window_s = t - t0
    else:
        from torch.profiler import ProfilerActivity, profile

        def window(activities):
            nonlocal converged
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(spec["trace_steps"]):
                    converged += cell.step()
                    sync()
                seconds = time.perf_counter() - t0
            return prof, seconds

        cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
        if device.type == "cuda":
            device_prof, window_s = window([cuda])
            host_prof, _ = window([cpu, cuda])
            steps = 2 * spec["trace_steps"]
        else:
            host_prof, window_s = window([cpu])
            device_prof = host_prof
            steps = spec["trace_steps"]
    converged = int(converged)
    attempted = steps * cell.rows
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if args.trace:
        t_read = time.perf_counter()

    cell.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    limits = spec["limits"]
    correct = all(name in limits and math.isfinite(v) and v <= limits[name]
                  for name, v in checks.items())

    result_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                     "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                     "count": spec["chips"] if device.type == "cuda" else 1,
                     "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        result_device["power_limit"] = power_limit()
    out = {"correct": bool(correct), "attempted": attempted, "failed": attempted - converged}
    if args.trace:
        trace = Trace(device_prof, host_prof, spec["trace_steps"], window_s, cell.work())
        metrics = layer_metrics(bench, args.workload, trace)
        result_device.update(busy_s=trace.busy_s, window_s=window_s)
        out["metrics"] = metrics
        out["device"] = result_device
        out["breakdown"] = trace.breakdown()
        print(f"trace: {steps} steps, {trace.device_ops} device ops, {trace.host_ops} aten ops, "
              f"{trace.syncs} syncs; read in {time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    else:
        wanted = set(end_to_end_names(bench, args.workload))
        values = {
            "rows_per_s": (converged / window_s, "rows/s"),
            "step_ms_p95": (float(np.percentile(np.array(step_s) * 1e3, 95)), "ms"),
            "peak_mem_gib": (memory_peak / 2**30, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in values.items() if k in wanted}
        out["metrics"] = metrics
        out["device"] = result_device
        print(f"window: {steps} steps in {window_s:.3f} s, {converged} of {attempted} rows "
              f"converged; step median {np.median(step_s) * 1e3:.4f} ms", file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"modules that must not be loaded are loaded: {found}", file=sys.stderr)
        return 3, None
    out["checks"] = {name: {"value": v, "limit": limits.get(name)} for name, v in checks.items()}
    for name, v in checks.items():
        print(f"check {name}: {v!r} limit {limits.get(name)!r}", file=sys.stderr)
    return 0, out
