"""The port's tracer (``feos_tpu_torch/tracing.py``) on the CPU: off it
records nothing; on, an entry call's spans nest entry -> solver -> kernel
under one root and its counters equal the solver's ``stats``; under
``torch.profiler`` each span is a FUNCTION-scope event on the tracer's
clock; the buffer stays bounded; and the benchmark's traced run reads the
tracer's counters."""

import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import feos_tpu_torch as ft
from feos_tpu_torch import tracing

REPO = Path(__file__).resolve().parents[1]


def _rows(n=8):
    params, temperature = (torch.as_tensor(x) for x in ft.make_batch(n, seed=3))
    return params, temperature


def _liquid_inputs():
    params, temperature = _rows()
    nans, p = ft.vapor_pressure(params, temperature)
    return params, temperature, torch.where(nans, 1e5, p)


def test_off_records_nothing():
    params, temperature, pressure = _liquid_inputs()
    before = (dict(tracing.profiled.counters), len(tracing.profiled.spans))
    assert not tracing.on()
    ft.liquid_density(params, temperature, pressure)
    assert (dict(tracing.profiled.counters), len(tracing.profiled.spans)) == before


def test_record_nests_entry_solver_kernel_and_counts_as_stats():
    params, temperature, pressure = _liquid_inputs()
    with tracing.record() as rec:
        ft.liquid_density(params, temperature, pressure)
    spans = {s.id: s for s in rec.spans}
    (entry,) = [s for s in spans.values() if s.parent is None]
    assert entry.name == tracing.PREFIX + "entry.liquid_density" and entry.rows == 8
    (solver,) = [s for s in spans.values() if s.parent == entry.id]
    assert solver.name == tracing.PREFIX + "solver.npt_density"
    kernels = [s for s in spans.values() if s.parent == solver.id]
    assert kernels and {s.name for s in kernels} == {tracing.PREFIX + "kernel.phi_d2"}
    assert {s.root for s in spans.values()} == {entry.id}
    for s in spans.values():
        outer = spans.get(s.parent)
        assert s.t0_ns <= s.t1_ns and (outer is None or outer.t0_ns <= s.t0_ns <= s.t1_ns
                                       <= outer.t1_ns)

    stats = {}
    p_red = pressure / temperature * ft.units.PA_PER_KT_TO_REDUCED
    with tracing.record() as solo:
        ft.npt_density(params, temperature, p_red, liquid=True, stats=stats)
    c = rec.counters
    assert c["calls.kernel.phi_d2"] == len(kernels) == stats["phi_d2_calls"]
    # each iteration's stop test, the last, and the branch sign's copy to the device
    assert c["sync.npt_density"] == stats["npt"] + 2
    assert c["npt_density.npt"] == solo.counters["npt_density.npt"] == stats["npt"]
    assert c["rows.entry.liquid_density"] == 8 and c["calls.entry.liquid_density"] == 1
    assert not any(k.startswith("launch.") for k in c)  # the CPU path launches nothing


def test_profiler_sees_function_scope_spans_on_the_tracer_clock():
    params, temperature = _rows(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.record() as rec:
            ft.vapor_pressure(params, temperature)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(tracing.PREFIX)), key=lambda e: e.start_ns())
    spans = sorted(rec.spans, key=lambda s: s.t0_ns)
    assert [e.name() for e in events] == [s.name for s in spans]
    for e, s in zip(events, spans):
        assert e.scope() == 0 and not e.is_user_annotation()
        assert e.device_type() != torch.autograd.DeviceType.CUDA
        assert abs(e.start_ns() - s.t0_ns) < 5_000_000
    assert not any(e.name().startswith(("aten::", tracing.PREFIX)) and "Synchronize" in e.name()
                   for e in events)


def test_buffer_is_bounded_and_counts_what_it_dropped(monkeypatch):
    params, temperature = _rows(4)
    monkeypatch.setattr(tracing, "CAPACITY", 4)
    with tracing.record() as rec:
        ft.vapor_pressure(params, temperature)
    opened = sum(n for k, n in rec.counters.items() if k.startswith("calls."))
    assert opened > 4
    assert len(rec.spans) == 4 and rec.dropped == opened - 4
    assert max(s.id for s in rec.spans) == opened  # the newest are kept


def test_benchmark_traced_run_reads_the_tracer(monkeypatch):
    """The harness's --trace 1 run of a shrunk pure_fit cell on the CPU: 4
    rows, no warm-up and one traced step (the CPU's plain solve dispatches
    about 40,000 aten ops a step, each a profiler event).  It runs in this
    process, where tests/conftest.py has loaded jax, so the harness's refusal
    of such a process (held by h100bench/tests/test_h100bench_run.py) is
    lifted; the tracer's profiled recorder starts empty."""
    monkeypatch.syspath_prepend(str(REPO))
    from h100bench import harness

    load_cell = harness.load_cell

    def shrunk(name):
        spec, config, traffic = load_cell(name)
        spec["trace_steps"] = 1
        return spec, config, traffic

    monkeypatch.setattr(harness, "load_cell", shrunk)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    monkeypatch.setattr(tracing, "profiled", tracing.Recorder())
    rc, res = harness.run(["--workload", "pure_fit.b100k", "--seed", "4294967311", "--seconds",
                           "1", "--trace", "1"], time.perf_counter(), device=torch.device("cpu"),
                          params={"rows": 4, "reference_block": 4, "warmup_steps": 0})
    assert rc == 0 and res["correct"]
    metrics = res["metrics"]
    counters = tracing.profiled.counters
    npt = counters["sync.npt_density"] / counters["calls.solver.npt_density"]
    assert metrics["solver.npt_syncs_per_call"]["value"] == npt >= 2  # a stop test and the last
    assert metrics["solver.syncs_in_program_per_step"]["value"] > npt  # the VLE's loops too
    assert "pure_vle.phi_evals_per_row" not in metrics  # no kernel ran on the CPU
    assert "device.idle_in_program_ms_per_step" not in metrics  # no device activity
