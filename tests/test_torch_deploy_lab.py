"""The port's deploy lab (``repro_torch.deploy``, the paper's cost study
in ``repro_torch.core``, ``launch/experiment.py`` and ``serve --ladder``)
against the JAX package's, on the CPU.

The copied modules are numpy and stdlib on both sides, so every copy must
return exactly what its original returns on the same inputs: compared by
``==`` on JSON-able values (NaN-free), or by ``np.testing`` at zero
tolerance. The load test runs against the port's engines on the smoke
configs in fp32. JAX's modules are imported in a fixture.
"""
import dataclasses
import importlib
import json
import math
import time

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core import corpus, loadtest
from repro_torch.deploy import costs, profiles, report, runner, telemetry
from repro_torch.launch import experiment, serve
from repro_torch.models import init_params
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.api import SamplingParams

ENC_CFG = dataclasses.replace(get_config("gector-base", smoke=True),
                              dtype="float32")
DEC_CFG = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype="float32")


@pytest.fixture(scope="module")
def jx():
    """``jx("deploy.costs")`` is the JAX package's module of that name."""
    pytest.importorskip("jax")
    return lambda name: importlib.import_module(f"repro.{name}")


def _port(name):
    return importlib.import_module(f"repro_torch.{name}")


def _both(jx, name, attr):
    return getattr(_port(name), attr), getattr(jx(name), attr)


# ------------------------------------------- (a) the cost study, by value
CALLS = [
    ("core.costmodel", "gpu_cost_premium", ()),
    ("core.costmodel", "machine_g_vs_f_premium", ()),
    ("core.costmodel", "machine_c_vs_e_saving", ()),
    ("core.costmodel", "cost_per_million_sentences", ()),
    ("core.costmodel", "cheapest_slo_compliant", ()),
    ("core.costmodel", "cheapest_slo_compliant", (512,)),
    ("core.costmodel", "max_ns_within_slo", ("Azure", "D")),
    ("core.perfsim", "validation_summary", ()),
    ("core.perfsim", "throughput_feature_regression", ()),
    ("core.perfsim", "cpu_only_feature_regression", ()),
    ("core.analysis", "all_findings", ()),
    ("core.analysis", "slo_capacity_table", ()),
    ("core.environments", "latency", ("GCP", "E", 64)),
    ("core.environments", "vcpu_load", ("AWS", "A", 512)),
    ("core.environments", "ram_load", ("Azure", "G", 1)),
]


@pytest.mark.parametrize("mod,fn,args", CALLS,
                         ids=[f"{m.split('.')[1]}.{f}{a}"
                              for m, f, a in CALLS])
def test_cost_study_functions_equal_jax(jx, mod, fn, args):
    ours, theirs = _both(jx, mod, fn)
    got, want = ours(*args), theirs(*args)
    assert got == want
    json.dumps(got)                      # JSON-able, so == is exact


def test_fitted_machine_models_equal_jax(jx):
    ours, theirs = _both(jx, "core.perfsim", "fit_all")
    got = {p: {m: dataclasses.asdict(v) for m, v in row.items()}
           for p, row in ours().items()}
    want = {p: {m: dataclasses.asdict(v) for m, v in row.items()}
            for p, row in theirs().items()}
    assert got == want


VALUES = {
    "PROFILES": lambda m: [p.spec_dict() for p in m.PROFILES],
    "paper_profiles": lambda m: [p.key for p in m.paper_profiles()],
    "NS_LADDER": lambda m: m.NS_LADDER,
    "LATENCY_SLO_S": lambda m: m.LATENCY_SLO_S,
    "HOURS_PER_MONTH": lambda m: m.HOURS_PER_MONTH,
    "PROVIDERS_MACHINES": lambda m: (m.PROVIDERS, m.MACHINES),
    "profile_by_key": lambda m: m.profile_by_key("TPU/T").spec_dict(),
}


@pytest.mark.parametrize("what", sorted(VALUES))
def test_price_book_equals_jax(jx, what):
    got = VALUES[what](profiles)
    assert got == VALUES[what](jx("deploy.profiles"))
    json.dumps(got)


def test_measured_tables_equal_jax(jx):
    env = _port("core.environments")
    assert env.MEASURED == jx("core.environments").MEASURED
    assert env.INSTANCES == list(profiles.PROFILES)   # the one record


# -------------------------------------------------------- (b) the corpus
def test_corpus_equals_jax(jx):
    cc = corpus.CorpusConfig(seed=0)
    ours = corpus.GECCorpus(cc)
    theirs = jx("core.corpus").GECCorpus(
        jx("core.corpus").CorpusConfig(seed=0))
    for got, want in zip(ours.generate(40), theirs.generate(40)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for got, want in zip(ours.batches(4, 32, 2), theirs.batches(4, 32, 2)):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert ours.stats() == theirs.stats()


# ----------------------------------------------------- (c) the telemetry
def _samples(cls, kind):
    if kind == "full":
        return [cls(t_s=i * 0.1, cpu_pct=float(i), per_core_pct=(
            float(i), 4.0 * i, 2.5), ram_pct=50.0 + i,
            pgfaults_per_s=10.0 * i) for i in range(11)]
    if kind == "absent":
        return [cls(t_s=i * 0.1, cpu_pct=None, per_core_pct=(),
                    ram_pct=None, pgfaults_per_s=None) for i in range(3)]
    if kind == "partial":                # gaps in cpu, ragged core counts
        return [cls(t_s=i * 0.05, cpu_pct=None if i % 3 else 7.0 * i,
                    per_core_pct=(1.0, 2.0) if i % 2 else (3.0, 4.0, 5.0),
                    ram_pct=40.0 - i, pgfaults_per_s=None)
                for i in range(7)]
    return []


@pytest.mark.parametrize("kind", ["full", "absent", "partial", "empty"])
def test_timeline_summary_equals_jax(jx, kind):
    theirs = jx("deploy.telemetry")
    got = telemetry.TelemetryTimeline(
        tuple(_samples(telemetry.TelemetrySample, kind))).summary()
    want = theirs.TelemetryTimeline(
        tuple(_samples(theirs.TelemetrySample, kind))).summary()
    assert got == want
    json.dumps(got)


def test_sampler_mark_and_window():
    with telemetry.HardwareSampler(period_s=0.02) as hw:
        time.sleep(0.12)
        hw.mark()
        first = hw.sample_now()
        w = hw.window()
    assert first is not None and first in w.samples
    assert len(w) >= 1 and all(s.t_s >= 0 for s in w.samples)
    assert w.summary()["n_samples"] == len(w)
    cs = telemetry.CpuSampler(period_s=0.02)
    with cs:
        time.sleep(0.08)
    assert isinstance(cs.mean, float)
    assert all(isinstance(v, float) for v in cs.samples)
    # one /proc parser: the load test's sampler is the telemetry's
    assert loadtest.CpuSampler is telemetry.CpuSampler
    assert loadtest.read_ram_pct is telemetry.read_ram_pct


# ----------------------------------------------- (d) costs and the report
def _record(prov, mach, cells, *, host="h1", kind="closed_ladder",
            name="t", ram_spread=1.0):
    return {"schema_version": 2,
            "profile": profiles.profile(prov, mach).spec_dict(),
            "scenario": {"name": name, "kind": kind, "mode": "encoder",
                         "repeats": 1},
            "engine": {"mode": "encoder"}, "cells": cells,
            "telemetry": ({} if ram_spread is None
                          else {"ram_spread_pct": ram_spread}),
            "engine_window": {}, "wall_s": 1.0, "host": {"id": host},
            "created_unix": 0.0}


def _cell(ns, latency_s):
    return {"ns": ns, "latency_s": latency_s, "latency_p95_s": latency_s,
            "vcpu_pct": 10.0 * ns, "ram_pct": 40.0, "repeats": 1,
            "sentences_per_s": ns / latency_s}


GRIDS = {
    # one host, CPU profiles only, one crossing the SLO at NS=16
    "single_host": [
        _record("AWS", "A", [_cell(1, 0.3), _cell(4, 0.9), _cell(16, 2.5)]),
        _record("GCP", "C", [_cell(1, 0.2), _cell(4, 0.4), _cell(16, 1.1)]),
    ],
    "cpu_gpu_pair": [
        _record("AWS", "C", [_cell(1, 0.2), _cell(4, 0.4), _cell(16, 4.0)]),
        _record("AWS", "G", [_cell(1, 0.05), _cell(4, 0.1),
                             _cell(16, 0.4)]),
    ],
    # a profile that never meets the SLO, beside one that does, and the
    # beyond-paper TPU/T row
    "never_meets_slo": [
        _record("Azure", "A", [_cell(1, 5.0), _cell(2, 7.0)]),
        _record("Azure", "F", [_cell(1, 0.1), _cell(2, 0.2)]),
        _record("TPU", "T", [_cell(1, 0.01), _cell(2, 0.02)]),
    ],
    # two hosts and no RAM telemetry: the cross-profile verdicts change
    "multi_host": [
        _record("AWS", "B", [_cell(1, 0.5), _cell(8, 0.9)], host="h1",
                ram_spread=None),
        _record("GCP", "G", [_cell(1, 0.1), _cell(8, 0.3)], host="h2",
                ram_spread=None),
        _record("GCP", "G", [{"n_requests": 4, "latency_p50_s": 0.1}],
                host="h2", kind="open_staggered", name="s"),
    ],
}

REPORTS = {
    "drift_report": lambda m, recs: m("deploy.report").drift_report(recs),
    "drift_report_target_1": lambda m, recs: m(
        "deploy.report").drift_report(recs, target_ns=1),
    "format_drift": lambda m, recs: m("deploy.report").format_drift(
        m("deploy.report").drift_report(recs)),
    "measured_cost_table": lambda m, recs: m(
        "deploy.costs").measured_cost_table(
            [r for r in recs if r["scenario"]["kind"] == "closed_ladder"]),
    "gpu_vs_cpu_premium": lambda m, recs: m(
        "deploy.costs").gpu_vs_cpu_premium(
            [r for r in recs if r["scenario"]["kind"] == "closed_ladder"]),
}


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("fn", sorted(REPORTS))
def test_costs_and_drift_report_equal_jax(jx, grid, fn):
    recs = GRIDS[grid]
    got = REPORTS[fn](_port, json.loads(json.dumps(recs)))
    want = REPORTS[fn](jx, json.loads(json.dumps(recs)))
    assert got == want
    json.dumps(got)


def test_drift_report_lists_every_paper_finding():
    rep = report.drift_report(GRIDS["cpu_gpu_pair"])
    assert set(rep["findings"]) == set(report.PAPER_FINDINGS)
    never = costs.measured_cost_table(GRIDS["never_meets_slo"])
    assert never["Azure/A"]["usd_per_1m_sentences"] == math.inf
    assert never["Azure/A"]["best_ns"] is None


def test_records_and_scenarios_keep_the_jax_schema(jx, tmp_path):
    theirs = jx("deploy.runner")
    for name in ("SCHEMA_VERSION", "RECORD_FIELDS", "KIND_LADDER",
                 "KIND_STAGGERED"):
        assert getattr(runner, name) == getattr(theirs, name)
    assert [f.name for f in dataclasses.fields(runner.ExperimentRecord)] \
        == [f.name for f in dataclasses.fields(theirs.ExperimentRecord)]
    for kw in ({"name": "l", "ladder": (1, 2)},
               {"name": "s", "kind": runner.KIND_STAGGERED,
                "mode": "decoder", "gap_s": 0.2}):
        assert runner.WorkloadScenario(**kw).to_dict() == \
            theirs.WorkloadScenario(**kw).to_dict()
    assert [p.key for p in runner.smoke_grid_profiles()] == \
        [p.key for p in theirs.smoke_grid_profiles()]
    recs = GRIDS["cpu_gpu_pair"]
    path = str(tmp_path / "g.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    assert runner.read_jsonl(path) == recs == theirs.read_jsonl(path)


@pytest.mark.parametrize("name", ["ExperimentRecord", "ExperimentRunner",
                                  "WorkloadScenario", "drift_report",
                                  "format_drift"])
def test_lazy_exports_resolve_in_the_port(name):
    import repro_torch.deploy as deploy
    assert getattr(deploy, name).__module__.startswith("repro_torch.deploy.")


# ------------------------------------------------------ (e) the load test
def test_mixed_bucket_prompts_and_table_equal_jax(jx):
    got = loadtest.mixed_bucket_prompts((8, 16), 9, 500, rng_seed=3)
    want = jx("core.loadtest").mixed_bucket_prompts((8, 16), 9, 500,
                                                    rng_seed=3)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    cells = [dict(ns=ns, latency_s=0.01 * ns, latency_p95_s=0.02 * ns,
                  vcpu_pct=3.0 * ns, ram_pct=41.5, repeats=2)
             for ns in (1, 16, 512)]
    assert loadtest.format_table([loadtest.LoadCell(**c) for c in cells]) \
        == jx("core.loadtest").format_table(
            [jx("core.loadtest").LoadCell(**c) for c in cells])


def test_run_ladder_on_the_encoder_engine():
    params = init_params(ENC_CFG, 0, device="cpu")
    eng = ServingEngine(ENC_CFG, params, EngineConfig(
        mode="encoder", max_batch=4, pad_buckets=(32,)), device="cpu")
    rng = np.random.default_rng(0)
    sents = [rng.integers(0, ENC_CFG.vocab_size, int(rng.integers(8, 24)))
             for _ in range(16)]
    try:
        cells = loadtest.run_ladder(eng, sents, ladder=(1, 2, 4), repeats=1)
        served = eng.window()
    finally:
        eng.close()
    assert [(c.ns, c.repeats) for c in cells] == [(1, 1), (2, 1), (4, 1)]
    assert all(c.latency_s > 0 and c.latency_p95_s > 0 for c in cells)
    # the warmup request was discarded: the window holds the ladder's
    assert served["requests"] == 1 + 2 + 4
    assert "NS    latency(s)" in loadtest.format_table(cells)


# ------------------------------------------------ (f) staggered arrivals
def test_run_staggered_on_the_decoder_engine():
    params = init_params(DEC_CFG, 0, device="cpu")
    eng = ServingEngine(DEC_CFG, params, EngineConfig(
        mode="decoder", continuous=False, use_cache_pool=False,
        max_batch=2, max_new_tokens=4, pad_buckets=(16,)), device="cpu")
    try:
        prompts = [np.arange(4 + i) % DEC_CFG.vocab_size for i in range(3)]
        r = loadtest.run_staggered(eng, prompts, gap_s=0.01,
                                   sampling=SamplingParams(max_new_tokens=2),
                                   keep_results=True)
    finally:
        eng.close()
    assert r.n_requests == 3 and r.total_tokens == 6
    assert [len(x.tokens) for x in r.results] == [2, 2, 2]
    assert r.queue_mean_s >= 0 and r.prefill_mean_s == 0.0
    assert r.decode_mean_s > 0 and r.queue_p95_s >= 0
    assert r.tokens_per_s > 0
    # the split refines the end-to-end latencies
    assert (r.queue_mean_s + r.prefill_mean_s + r.decode_mean_s
            <= r.latency_p95_s * 3 + 1e-6)


# ------------------------------------------------- (g) the experiment CLI
def test_smoke_grid_writes_the_port_artifacts(jx, tmp_path):
    experiment.main(["--smoke", "--device", "cpu", "--out-dir",
                     str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "EXPERIMENT_torch_drift.json", "EXPERIMENT_torch_grid.jsonl"]
    theirs = jx("deploy.runner")
    rows = runner.read_jsonl(str(tmp_path / experiment.GRID_FILE))
    assert [r["profile"]["machine"] for r in rows] == ["C", "G"]
    for row in rows:
        assert tuple(sorted(row)) == tuple(sorted(theirs.RECORD_FIELDS))
        assert row["schema_version"] == theirs.SCHEMA_VERSION
        assert [c["ns"] for c in row["cells"]] == [1, 2]
        assert all(c["latency_s"] > 0 and c["sentences_per_s"] > 0
                   for c in row["cells"])
        assert row["engine_window"]["requests"] == 3     # 1 + 2, once
        assert row["engine"]["continuous"] is False
    want = jx("deploy.report").drift_report(rows)
    assert report.drift_report(rows) == want
    with open(tmp_path / experiment.DRIFT_FILE) as f:
        assert json.load(f) == json.loads(json.dumps(want))


@pytest.mark.parametrize("flag,names", [
    ("--staggered", ("staggered",)),
    ("--prefix-cache", ("staggered_shared", "staggered_shared_pc")),
    ("--quant", ("staggered_quant", "staggered_quant_q8")),
    ("--spec-decode", ("staggered_spec", "staggered_spec_sd")),
])
def test_decoder_scenarios_raise_naming_their_items(jx, tmp_path,
                                                     monkeypatch, flag,
                                                     names):
    """The decoder scenarios serve through the continuous decoder with
    chunked prefill, the prefix cache, int8 W+KV and speculative
    decoding (self-drafted), on the smoke grid: the scenarios, engine
    configs and prompts are the ones JAX's CLI builds for the same flags
    (its engine stubbed), every record has JAX's fields and a
    compile-clean window, the ``_sd`` window ran speculative rounds, and
    the drift report's A/B cells are what JAX's pricers make of the same
    records."""
    out = tmp_path / "out"
    argv = ["--smoke", "--device", "cpu", "--profiles", "AWS/C",
            "--requests", "3", flag, "--out-dir", str(out)]
    made = {}
    factory = experiment.make_engine_factory

    def recording(args):
        make = factory(args)

        def build(scenario):
            eng, sentences, sampling = make(scenario)
            made[scenario.name] = (eng.ec, sentences, sampling)
            return eng, sentences, sampling
        return build
    monkeypatch.setattr(experiment, "make_engine_factory", recording)
    experiment.main(argv)

    theirs = jx("launch.experiment")
    built = {}

    class StubEngine:                    # JAX's factory, no engine served
        def __init__(self, cfg, params, ec, draft=None):
            built["ec"] = ec

        def warmup(self):
            pass
    monkeypatch.setattr(theirs, "ServingEngine", StubEngine)
    import argparse
    ns = argparse.Namespace(
        smoke=True, ladder=[1, 2], repeats=1, staggered=flag ==
        "--staggered", prefix_cache=flag == "--prefix-cache",
        quant=flag == "--quant", spec_decode=flag == "--spec-decode",
        spec_k=4,
        arch="qwen2-0.5b", requests=3, gap=0.05, max_new_tokens=8,
        max_batch=4, max_inflight=None, bucket=32, segment_width="adaptive",
        seed=0)
    want = theirs.build_scenarios(ns)
    assert [s.name for s in want] == ["ladder", *names]
    rows = runner.read_jsonl(str(out / experiment.GRID_FILE))
    assert [r["scenario"]["name"] for r in rows] == ["ladder", *names]
    jfactory = theirs.make_engine_factory(ns)
    for sc, row in zip(want[1:], rows[1:]):
        assert row["scenario"] == sc.to_dict()
        assert tuple(sorted(row)) == tuple(sorted(
            jx("deploy.runner").RECORD_FIELDS))
        _, jsent, jsp = jfactory(sc)
        ec, sent, sp = made[sc.name]
        assert {k: v for k, v in dataclasses.asdict(ec).items()} == {
            k: getattr(built["ec"], k) for k in dataclasses.asdict(ec)}
        assert len(sent) == len(jsent) == 64
        for a, b in zip(sent, jsent):
            np.testing.assert_array_equal(a, b)
        assert sp.max_new_tokens == jsp.max_new_tokens == 8
        cell, win = row["cells"][0], row["engine_window"]
        assert cell["n_requests"] == 3 and cell["total_tokens"] == 24
        assert win["requests"] == 3 and win["jit_compiles"] == 0
        assert row["engine"]["continuous"] is True
        lanes = win["lanes"].values()
        if sc.name.endswith("_pc"):
            assert sum(l["prefix_hits"] + l["prefix_misses"]
                       for l in lanes) == 3
        assert (sum(l["spec_rounds"] for l in lanes) > 0) is \
            sc.name.endswith("_sd")
    with open(out / experiment.DRIFT_FILE) as f:
        drift = json.load(f)
    for key, fn in (("prefix_cache", "prefix_cache_cells"),
                    ("quant", "quant_cells"),
                    ("spec_decode", "spec_decode_cells")):
        if key not in drift:
            continue
        cells = getattr(experiment, fn)(rows)
        assert cells == getattr(theirs, fn)(rows)
        assert len(cells) == 1 and drift[key] == json.loads(
            json.dumps(cells))
    assert ("prefix_cache" in drift) is (flag == "--prefix-cache")
    assert ("quant" in drift) is (flag == "--quant")
    assert ("spec_decode" in drift) is (flag == "--spec-decode")


# --------------------------------------------------- (i) engine summary
def test_engine_summary_has_the_jax_keys(jx):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jax_get_config
    from repro.models import init_params as jax_init_params
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    jcfg = jax_get_config("gector-base", smoke=True)
    jeng = JaxServingEngine(jcfg, jax_init_params(jcfg, jax.random.PRNGKey(0)),
                            JaxEngineConfig(mode="encoder", max_batch=2,
                                            pad_buckets=(16,)))
    engines = [
        ServingEngine(ENC_CFG, init_params(ENC_CFG, 0, device="cpu"),
                      EngineConfig(mode="encoder", max_batch=2,
                                   pad_buckets=(16,)), device="cpu"),
        ServingEngine(ENC_CFG, init_params(ENC_CFG, 0, device="cpu"),
                      EngineConfig(mode="encoder", max_batch=2,
                                   pad_buckets=(16,), weight_quant="int8"),
                      device="cpu"),
        ServingEngine(DEC_CFG, init_params(DEC_CFG, 0, device="cpu"),
                      EngineConfig(mode="decoder", continuous=False,
                                   use_cache_pool=False, max_batch=2,
                                   pad_buckets=(16,), weight_quant="int8",
                                   kv_quant="int8"), device="cpu")]
    try:
        want = jx("deploy.runner")._engine_summary(jeng)
        base, q8, dec = (runner._engine_summary(e) for e in engines)
    finally:
        jeng.close()
        for e in engines:
            e.close()
    assert set(base) == set(q8) == set(dec) == set(want)
    assert base["continuous"] is q8["continuous"] is dec["continuous"] \
        is False
    assert (base["weight_quant"], q8["weight_quant"]) == (None, "int8")
    assert (dec["weight_quant"], dec["kv_quant"]) == ("int8", "int8")
    assert 0 < q8["weight_bytes"] < base["weight_bytes"]
    assert {k: base[k] for k in ("mode", "max_batch", "pad_buckets",
                                 "prefix_cache", "spec_decode")} == \
        {k: want[k] for k in ("mode", "max_batch", "pad_buckets",
                              "prefix_cache", "spec_decode")}
    json.dumps(dec)


# ------------------------------------------------------ (j) serve --ladder
def test_serve_cli_runs_the_ladder(capsys):
    serve.main(["--smoke", "--device", "cpu", "--ladder", "1", "2"])
    out = capsys.readouterr().out.splitlines()
    head = out.index("NS    latency(s)  p95(s)   vCPU%   RAM%")
    assert [line.split()[0] for line in out[head + 1:head + 3]] == ["1", "2"]


def _serve_decoder(capsys, *flags):
    """The serve CLI on the smoke Qwen2 on the CPU: (streamed tokens of
    the first request or None, its result's tokens)."""
    serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                "--requests", "2", "--max-new-tokens", "6", *flags])
    out = capsys.readouterr().out.splitlines()
    streamed = [json.loads("[" + ", ".join(line.split(":")[1].split())
                           + "]")
                for line in out if line.startswith("request[0] stream:")]
    tokens, = [json.loads(line.split(":", 1)[1]) for line in out
               if line.startswith("tokens of the first request:")]
    return (streamed[0] if streamed else None), tokens


@pytest.mark.parametrize("flag", ["--stream", "--eos-id", "--top-k"])
def test_serve_cli_decoder_flags(capsys, flag):
    _, greedy = _serve_decoder(capsys)
    assert len(greedy) == 6
    if flag == "--stream":
        streamed, tokens = _serve_decoder(capsys, "--stream")
        assert streamed == tokens == greedy
    elif flag == "--eos-id":
        eos = greedy[1]
        _, tokens = _serve_decoder(capsys, "--eos-id", str(eos))
        assert tokens == greedy[:greedy.index(eos) + 1]
    else:
        # one candidate: sampling at any temperature is greedy decoding
        _, tokens = _serve_decoder(capsys, "--temperature", "0.8",
                                   "--top-k", "1")
        assert tokens == greedy
        _, sampled = _serve_decoder(capsys, "--temperature", "0.8",
                                    "--top-k", "50")
        assert len(sampled) == 6
