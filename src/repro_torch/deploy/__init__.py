"""Deployment lab — the live counterpart of the paper's experiment protocol.

The paper's contribution is a *protocol*, not a table: 7 machine classes
across 3 providers, repeated load experiments, real-time latency + hardware
usage + cost. ``repro_torch.core`` replays the paper's published numbers;
this package re-runs the protocol against the serving engine built in this
repo:

  * ``profiles``  — executable environment profiles (provider x machine
    specs + the price book), the single source of truth that
    ``core.environments`` / ``core.costmodel`` re-export from;
  * ``telemetry`` — background hardware sampler (per-core CPU, RAM,
    page-fault proxy) with ring-buffer timelines and percentile summaries;
  * ``runner``    — the profile x scenario experiment grid, emitting
    structured ``ExperimentRecord`` JSONL;
  * ``costs``     — live cost accounting from *measured* throughput
    ($ / 1M sentences, GPU-vs-CPU break-even, cheapest-SLO selection);
  * ``report``    — the drift report: paper findings recomputed from
    measured data and diffed against ``core.analysis`` expectations.

Import layering: ``profiles`` and ``telemetry`` are leaf modules (``core``
imports *them*); ``runner``/``costs``/``report`` sit above ``core`` and
``serving`` and are therefore loaded lazily here to keep
``core.environments -> deploy.profiles`` cycle-free.

A copy of ``repro/deploy/__init__.py`` with names, signatures and
records unchanged: the port imports nothing of ``repro``.
"""
from repro_torch.deploy.profiles import (  # noqa: F401
    HOURS_PER_MONTH, LATENCY_SLO_S, MACHINES, NS_LADDER, PROFILES, PROVIDERS,
    EnvironmentProfile, paper_profiles, profile, profile_by_key)
from repro_torch.deploy.telemetry import (  # noqa: F401
    CpuSampler, HardwareSampler, TelemetrySample, TelemetryTimeline)

_LAZY = {
    "ExperimentRecord": "repro_torch.deploy.runner",
    "ExperimentRunner": "repro_torch.deploy.runner",
    "WorkloadScenario": "repro_torch.deploy.runner",
    "drift_report": "repro_torch.deploy.report",
    "format_drift": "repro_torch.deploy.report",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(mod), name)
