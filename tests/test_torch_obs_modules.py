"""The port's observability modules against the JAX package's.

``cake_tpu_torch/utils/metrics.py`` and ``cake_tpu_torch/obs/`` (taxonomy,
timeline, requestlog, timeseries, efficiency, critpath, blackbox, slo) are
copies of the reference's stdlib modules. Every case here feeds the same
sequence of calls to both packages' modules, each on its own fake clock
(every ``time.time``/``perf_counter``/``monotonic`` call advances it by a
fixed step, so the same call sequence stamps the same times), and holds the
outputs equal: exposition text, flight rings, span trees and Chrome JSON,
request-log lines, windows, snapshots and audit records, decompositions and
bundles. The cases mirror tests/test_metrics.py, test_timeline.py,
test_requestlog.py, test_timeseries.py, test_efficiency.py,
test_critpath.py and test_blackbox.py.
"""

from __future__ import annotations

import importlib
import itertools
import json
import os
import types

import pytest

MODULES = ("utils.metrics", "obs.taxonomy", "obs.timeline", "obs.requestlog", "obs.timeseries",
           "obs.efficiency", "obs.critpath", "obs.blackbox", "obs.slo")
PACKAGES = ("cake_tpu", "cake_tpu_torch")


class FakeTime:
    """A ``time`` module stand-in: every clock read advances 0.25 s."""

    def __init__(self, start: float = 1_700_000_000.0):
        self.t = start

    def _tick(self) -> float:
        self.t += 0.25
        return self.t

    def time(self) -> float:
        return self._tick()

    def perf_counter(self) -> float:
        return self._tick()

    def monotonic(self) -> float:
        return self._tick()

    def sleep(self, s: float) -> None:
        self.t += s


def _load(pkg: str, monkeypatch) -> types.SimpleNamespace:
    """One package's obs modules, each on a fresh fake clock and span ids."""
    ns = {}
    for name in MODULES:
        mod = importlib.import_module(f"{pkg}.{name}")
        if hasattr(mod, "time"):
            monkeypatch.setattr(mod, "time", FakeTime())
        ns[name.split(".")[1]] = mod
    monkeypatch.setattr(ns["timeline"], "_ids", itertools.count(1))
    return types.SimpleNamespace(**ns)


@pytest.fixture
def both(monkeypatch):
    """Run ``scenario(pkg)`` on the reference and on the port; returns the
    two results."""

    def run(scenario, *args):
        out = []
        for pkg in PACKAGES:
            out.append(scenario(_load(pkg, monkeypatch), *args))
        return out

    return run


def _equal(both, scenario, *args):
    ref, port = both(scenario, *args)
    assert port == ref
    return port


# ------------------------------------------------------------------ metrics


def test_taxonomy_registries_equal(both):
    def names(m):
        t = m.taxonomy
        return {k: getattr(t, k) for k in dir(t) if k.isupper()}

    out = _equal(both, names)
    assert "PHASES" in out and "BUCKETS" in out and "REQUEST_LOG_FIELDS" in out


def _histograms(m):
    reg = m.metrics.MetricsRegistry()
    h = reg.histogram("lat_seconds", "Latency.")
    for v in (0.0004, 0.003, 0.003, 0.04, 0.2, 0.9, 7.0, 45.0):
        h.observe(v)
    h.observe(0.02, phase="decode")
    h.observe(0.5, phase="prefill")
    small = reg.histogram("rows", "Rows a batch.", buckets=(1, 2, 4, 8))
    for v in (1, 3, 3, 8, 9):
        small.observe(v)
    return {
        "expose": reg.expose(),
        "snapshot": reg.snapshot(),
        "dump": reg.dump(),
        "pcts": [h.percentile(q) for q in (0, 10, 50, 90, 99, 100)],
        "labelled": h.percentile(50, phase="decode"),
        "empty": reg.histogram("never", "").percentile(50),
    }


def _counters_gauges(m):
    reg = m.metrics.MetricsRegistry()
    c = reg.counter("cake_x_total", "Xs.")
    c.inc()
    c.inc(3, node="w1")
    c.inc(2.5, node='we"ird\\la\nbel')
    g = reg.gauge("cake_level", "Level.\nsecond line")
    g.set(4)
    g.inc(2)
    g.dec(1.5)
    g.set(7, tenant="a")
    errs = []
    try:
        c.inc(-1)
    except ValueError as e:
        errs.append(str(e))
    try:
        reg.gauge("cake_x_total")
    except ValueError as e:
        errs.append(str(e))
    assert reg.counter("cake_x_total") is c
    return {"expose": reg.expose(), "snapshot": reg.snapshot(), "dump": reg.dump(),
            "values": [c.value(), c.value(node="w1"), g.value(), g.value(tenant="a")],
            "errors": errs}


def _merged(m):
    a, b = m.metrics.MetricsRegistry(), m.metrics.MetricsRegistry()
    a.counter("ops_total", "Ops.").inc(3)
    a.histogram("op_seconds", "Op time.", buckets=(0.1, 1.0)).observe(0.5)
    b.counter("ops_total", "Ops (worker).").inc(5, node="w9")
    b.gauge("op_seconds", "Kind clash.").set(1)
    b.histogram("wire_seconds", "Wire.", buckets=(0.01,)).observe(0.2)
    return m.metrics.merged_exposition([("master", a.dump()), ("w1", b.dump())])


@pytest.mark.parametrize("scenario", [_histograms, _counters_gauges, _merged],
                         ids=["histograms", "counters_gauges", "merged_exposition"])
def test_registry_exposition_equals_the_reference(both, scenario):
    _equal(both, scenario)


def _flight(m, tmp):
    fr = m.metrics.FlightRecorder(capacity=4)
    stream = os.path.join(tmp, f"{m.metrics.__name__}.stream.jsonl")
    fr.attach_jsonl(stream)
    fr.record("submitted", "r1", prompt_tokens=7)
    with m.timeline.timeline.span("epoch", track="engine"):
        fr.record("admitted", "r1", queue_wait_s=0.5)
    fr.record("shed", reason="queue depth")
    for i in range(3):
        fr.record("first-token", f"r{i}", ttft_s=0.1 * i)
    fr.attach_jsonl(None)
    fr.record("finished", "r2", finish_reason="stop")
    dump = os.path.join(tmp, f"{m.metrics.__name__}.dump.jsonl")
    n = fr.dump_jsonl(dump)
    out = {"ring": fr.snapshot(), "r1": fr.snapshot(request_id="r1"), "capacity": fr.capacity,
           "dumped": n, "dump": open(dump).read(), "stream": open(stream).read()}
    fr.clear()
    out["cleared"] = fr.snapshot()
    return out


def test_flight_recorder_ring_and_jsonl_equal_the_reference(both, tmp_path):
    out = _equal(both, _flight, str(tmp_path))
    assert len(out["ring"]) == 4 and out["stream"].count("\n") == 6
    rid = importlib.import_module("cake_tpu_torch.utils.metrics").new_request_id()
    ref = importlib.import_module("cake_tpu.utils.metrics").new_request_id()
    assert rid.startswith("req-") and len(rid) == len(ref)


# ----------------------------------------------------------------- timeline


def _span_tree(m):
    tl = m.timeline.Timeline(node="master")
    with tl.span("epoch", rid="r1", track="engine", args={"rows": 2}) as outer:
        sid = tl.begin("request", rid="r1", track="lane0", args={"prompt_tokens": 4},
                       parent=None)
        with tl.span("prefill", track="engine", args={"bucket": 64}):
            tl.instant("kernel:decode", track="engine", args={"impl": "cuda"})
        with tl.span("wire.w0", track="wire"):
            tl.flow_start(42, "hop", track="wire")
        with tl.span("op", node="worker0", track="ops"):
            tl.flow_end(42, "hop", node="worker0", track="ops")
        tl.counter("kv_pages", {"in_use": 3.0, "free": 5.0}, track="mem")
        tl.end(sid, args={"finish_reason": "stop"})
        tl.begin("request", rid="r2", track="lane1")  # still open
    trace = tl.export()
    return {"outer": outer, "events": tl.snapshot(), "r1": tl.snapshot("r1"),
            "export": trace, "export_r1": tl.export("r1"),
            "valid": m.timeline.validate_export(trace), "aggregate": tl.aggregate()}


def _eviction(m):
    tl = m.timeline.Timeline(capacity=5)
    for i in range(4):
        sid = tl.begin("request", rid=f"r{i}", track=f"lane{i}")
        with tl.span("decode-chunk", track="engine", args={"n": 8}):
            pass
        tl.end(sid)
    trace = tl.export()
    return {"events": tl.snapshot(), "export": trace, "valid": m.timeline.validate_export(trace)}


def _validator(m):
    bad = {"traceEvents": [
        {"ph": "B", "name": "x", "pid": 1, "tid": 1, "ts": 0.0},
        {"ph": "s", "name": "hop", "pid": 1, "tid": 1, "ts": 5.0, "id": 3},
        {"ph": "f", "name": "hop", "pid": 1, "tid": 2, "ts": 6.0},
        {"ph": "E", "name": "y", "pid": 1, "tid": 3, "ts": 1.0},
    ]}
    return {"bad": m.timeline.validate_export(bad),
            "empty": m.timeline.validate_export({"traceEvents": []})}


def _jsonl_roundtrip(m, tmp):
    tl = m.timeline.Timeline()
    path = os.path.join(tmp, f"{m.timeline.__name__}.jsonl")
    tl.attach_jsonl(path)
    with tl.span("segment", rid="r", track="engine"):
        step = tl.begin("step", track="engine", args={"slot": 3})
        tl.instant("preempted", rid="r", track="lane1", args={"reason": "self"})
        tl.end(step, args={"joins": 1})
    tl.attach_jsonl(None)
    events = m.timeline.load_jsonl(path)
    return {"events": events, "export": m.timeline.export_events(events, default_node="n0")}


@pytest.mark.parametrize("scenario", [_span_tree, _eviction, _validator],
                         ids=["span_tree", "eviction", "validator"])
def test_timeline_equals_the_reference(both, scenario):
    _equal(both, scenario)


def test_timeline_jsonl_and_chrome_export_equal_the_reference(both, tmp_path):
    out = _equal(both, _jsonl_roundtrip, str(tmp_path))
    assert {e["name"] for e in out["events"]} >= {"segment", "step", "preempted"}
    json.dumps(out["export"])  # JSON all the way down


# --------------------------------------------------------------- requestlog


def _requestlog(m, tmp):
    log = m.requestlog.RequestLog(keep=3, time_fn=lambda: 1234.5)
    path = os.path.join(tmp, f"{m.requestlog.__name__}.jsonl")
    log.attach_jsonl(path)
    errors = []
    for bad in ({"request_id": "x", "tenant": "t", "finish_reason": "stop", "bogus": 1},
                {"request_id": "x", "tenant": "t", "finish_reason": "exploded"},
                {"request_id": "x", "tenant": "t", "finish_reason": "stop", "seq": 4},
                {"tenant": "t", "finish_reason": "stop"}):
        try:
            log.record(**bad)
        except ValueError as e:
            errors.append(str(e))
    recs = [
        log.record(request_id="a", tenant="alice", finish_reason="stop", prompt_tokens=7,
                   completion_tokens=3, ttft_s=0.1, phases={"queue": 0.01}, t_wall=10.0),
        log.record(request_id="b", tenant="bob", finish_reason="quota", slo="refused",
                   t_wall=12.5),
        log.record(request_id="c", tenant="alice", finish_reason="length",
                   decisions=["admit:fair_order"]),
        log.record(request_id="d", tenant="alice", finish_reason="deadline", slo="deadline_miss"),
    ]
    log.attach_jsonl(None)
    with open(path, "a") as f:
        f.write("not json\n")
    return {"errors": errors, "recs": recs, "snap": log.snapshot(),
            "alice": log.snapshot(tenant="alice"), "since": log.snapshot(since=2),
            "limit": log.snapshot(limit=1), "stats": {**log.stats(), "jsonl": None},
            "len": len(log), "trace": m.requestlog.load_trace(path)}


def test_request_log_lines_equal_the_reference(both, tmp_path):
    out = _equal(both, _requestlog, str(tmp_path))
    assert len(out["errors"]) == 4 and [r["seq"] for r in out["snap"]] == [2, 3, 4]


# --------------------------------------------------------------- timeseries


def _timeseries(m):
    clock = types.SimpleNamespace(t=1000.0)
    ts = m.timeseries.SliTimeseries(window_s=30.0, bucket_s=5.0, time_fn=lambda: clock.t,
                                    max_samples=8)
    out = {"empty": ts.series()["points"]}
    for i in range(12):
        ts.observe_ttft(0.05 * (i + 1))
    ts.observe_tokens(10)
    ts.observe_finish("stop")
    ts.observe_finish("quota")
    clock.t = 1012.0  # a gap bucket
    ts.observe_finish("shed")
    ts.observe_finish("error")
    ts.observe_tokens(3)
    out["mid"] = [{k: v for k, v in p.items() if k != "t_wall"} for p in ts.series()["points"]]
    clock.t = 1100.0  # past the window
    ts.observe_ttft(0.2)
    series = ts.series()
    out["late"] = [{k: v for k, v in p.items() if k != "t_wall"} for p in series["points"]]
    out["geometry"] = {k: v for k, v in series.items() if k != "points"}
    out["pct"] = [m.timeseries._percentile([0.4, 0.1, 0.2, 0.3], q) for q in (0.0, 0.5, 0.99)]
    return out


def test_timeseries_windows_equal_the_reference(both):
    out = _equal(both, _timeseries)
    assert out["empty"] == [] and len(out["mid"]) >= 2


# --------------------------------------------------------------- efficiency


def _config(m, moe: bool = False):
    pkg = m.metrics.__name__.split(".")[0]
    cfg_mod = importlib.import_module(f"{pkg}.models.llama.config")
    kw = {"num_hidden_layers": 2}
    if moe:
        kw.update(num_local_experts=4, num_experts_per_tok=2, moe_intermediate_size=48)
    return cfg_mod.LlamaConfig.tiny(**kw)


def _ledger(m):
    clock = types.SimpleNamespace(t=100.0)
    audit = m.efficiency.DecisionAudit(keep=6, time_fn=lambda: clock.t)
    led = m.efficiency.EfficiencyLedger(config=_config(m), peak_tflops=100.0,
                                        peak_hbm_gbps=1000.0, time_fn=lambda: clock.t,
                                        audit=audit)
    clock.t = 101.0
    led.note_prefill(1.0, lanes=4, width=8, own_tokens=20)
    clock.t = 103.5
    led.note_decode(2.0, lanes=4, n=4, live=3, consumed=10, slot=8)
    clock.t = 104.5
    led.note_spec(1.0, lanes=2, k=3, live=2, used=5, slot=8)
    clock.t = 105.75
    led.note_stall(1.0)
    clock.t = 106.25
    led.note_failover(0.5)
    clock.t = 107.25
    led.note_prefill(1.0, lanes=1, width=16, own_tokens=8, restore=True)
    led.note_prefill(0.0, lanes=1, width=4, own_tokens=4)  # dropped
    for tenant, reason, n in (("gold", "stop", 10), ("gold", "cancelled", 3),
                              ("free", "length", 4), ("free", "deadline", 2),
                              ("free", "weird", 1), ("free", "stop", 0)):
        led.note_finish(tenant, reason, n)
    for action, cause, rid in (("admit", "fair_order", "r1"), ("defer", "page_pressure", "r2"),
                               ("defer", "page_pressure", "r2"), ("preempt", "page_pressure", "r1"),
                               ("restore", "fair_order", "r1"), ("budget", "slo_feedback", ""),
                               ("shed", "queue_depth", ""), ("join", "fair_order", "r3"),
                               ("defer", "capacity", "r4")):
        audit.record(action, cause, rid=rid, tenant="t", detail="d")
    errors = []
    for bad in (("evaporate", "fair_order"), ("admit", "because")):
        try:
            audit.record(*bad)
        except ValueError as e:
            errors.append(str(e))
    snap = led.snapshot()
    led.reset()
    return {"snap": snap, "after_reset": led.snapshot(), "ring": audit.snapshot(),
            "limit": audit.snapshot(limit=2), "r1": audit.for_request("r1"),
            "counts": audit.counts(), "errors": errors}


def _roofline_model(m):
    out = {}
    for moe in (False, True):
        cfg = _config(m, moe)
        out[f"moe={moe}"] = {
            "active": m.efficiency.model_active_params(cfg),
            "flops": m.efficiency.dispatch_flops(cfg, 8, 32, 1),
            "bytes": m.efficiency.dispatch_hbm_bytes(cfg, 8, 32, passes=4),
        }
    led = m.efficiency.EfficiencyLedger(config=_config(m), time_fn=lambda: 1.0)
    out["cpu"] = {"source": led.peak_source, "peaks": m.efficiency.device_peaks()}
    return out


def test_efficiency_snapshots_and_audit_equal_the_reference(both):
    out = _equal(both, _ledger)
    snap = out["snap"]
    assert snap["accounted_s"] == pytest.approx(snap["wall_s"]) and len(out["errors"]) == 2


def test_roofline_model_equals_the_reference_and_the_cpu_has_no_peaks(both):
    out = _equal(both, _roofline_model)
    assert out["cpu"] == {"source": "none", "peaks": None}


def test_device_peaks_know_the_h100_by_its_name(monkeypatch):
    """The port's peak table keys on ``torch.cuda.get_device_name()``: the
    H100 SXM's datasheet bf16 dense and HBM3 peaks; another card, none."""
    import torch

    from cake_tpu_torch.obs import efficiency

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    assert efficiency.device_peaks() == (989.4, 3350.0, "NVIDIA H100 80GB HBM3")
    led = efficiency.EfficiencyLedger()
    assert (led.peak_source, led.peak_hbm_gbps) == ("NVIDIA H100 80GB HBM3", 3350.0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert efficiency.device_peaks() is None


# ----------------------------------------------------------------- critpath


def _ev(ph, name, mono, **kw):
    e = {"ph": ph, "name": name, "wall": mono, "mono": mono}
    e.update(kw)
    return e


def _span(name, t0, t1, **kw):
    return _ev("X", name, t0, dur=t1 - t0, **kw)


ORACLES = {
    "mixed_epoch": [
        _ev("B", "request", 1.0, id=1, rid="short", track="lane0",
            args={"prompt_tokens": 4, "queue_wait_s": 0.5, "admit_s": 0.01}),
        _ev("B", "request", 1.0, id=2, rid="long", track="lane1",
            args={"prompt_tokens": 64, "queue_wait_s": 0.5}),
        _span("prefill", 1.0, 2.0, track="engine", args={"bucket": 64, "lanes": 2}),
        _span("decode-chunk", 2.0, 3.0, track="engine", args={"slot": 64, "n": 8, "live": 2}),
        _ev("E", "", 3.0, id=1, args={"finish_reason": "stop", "completion_tokens": 3}),
        _span("decode-chunk", 3.0, 4.0, track="engine", args={"slot": 72, "n": 8, "live": 1}),
        _span("decode-chunk", 4.0, 5.0, track="engine", args={"slot": 80, "n": 8, "live": 1}),
        _ev("E", "", 5.0, id=2, args={"finish_reason": "length", "completion_tokens": 25}),
    ],
    "stall_spec_wire": [
        _ev("B", "request", 0.0, id=9, rid="r", track="lane0",
            args={"prompt_tokens": 32, "queue_wait_s": 0.0}),
        _span("prefill", 0.0, 1.0, track="engine", args={"bucket": 32}),
        _span("spec-round", 1.0, 2.0, track="engine", args={"slot": 32, "accepted": 2, "k": 3}),
        _span("decode-chunk", 2.0, 3.0, track="engine", args={"slot": 34, "n": 4}),
        _ev("i", "epoch-stall", 2.9, track="engine", args={"op": "decode", "stall_s": 0.5}),
        _span("wire.w0", 0.2, 0.6, track="wire"),
        _ev("E", "", 3.0, id=9, args={"finish_reason": "error", "completion_tokens": 5}),
    ],
    "join_in_flight": [
        _ev("B", "request", 5.0, id=4, rid="j", track="lane2",
            args={"prompt_tokens": 8, "queue_wait_s": 1.0, "join_slot": 64}),
        _span("join", 5.0, 5.4, rid="j", track="engine", args={"lane": 2, "slot": 64}),
        _span("prefill", 1.0, 2.0, track="engine", args={"bucket": 64}),
        _span("decode-chunk", 5.4, 6.4, track="engine", args={"slot": 64, "n": 8}),
    ],
    "fork_restore": [
        _ev("B", "request", 0.0, id=1, rid="a", track="lane0",
            args={"prompt_tokens": 32, "queue_wait_s": 0.0}),
        _span("prefill", 0.0, 1.0, track="engine", args={"bucket": 32, "lanes": 2}),
        _span("prefix-fork", 0.1, 0.3, track="engine", args={"lanes": 2}),
        _span("join", 1.0, 1.5, rid="b", track="engine", args={"lane": 1, "slot": 40}),
        _span("prefix-fork", 1.1, 1.2, track="engine", args={"lane": 1, "slot": 40}),
        _span("decode-chunk", 1.5, 2.5, track="engine", args={"slot": 40, "n": 4}),
        _ev("E", "", 2.5, id=1, args={"finish_reason": "stop", "completion_tokens": 5}),
        _ev("B", "request", 3.0, id=5, rid="a", track="lane1",
            args={"prompt_tokens": 32, "queue_wait_s": 0.0, "join_slot": 44}),
        _span("restore", 3.0, 3.4, rid="a", track="engine",
              args={"lane": 1, "slot": 44, "tokens": 36}),
        _span("decode-chunk", 3.4, 4.4, track="engine", args={"slot": 44, "n": 4}),
        _ev("E", "", 4.4, id=5, args={"finish_reason": "length", "completion_tokens": 9}),
    ],
}


def _explain(m, name):
    events = ORACLES[name]
    cp = m.critpath
    out = {"ids": cp.request_ids(events), "all": cp.explain_all(events)}
    for rid in out["ids"] + ["nope"]:
        res = cp.explain(events, rid)
        out[rid] = res
        if res is not None:
            out[f"{rid}.render"] = cp.render(res)
    out["dominant"] = [cp.dominant(p) for p in ({"queue": 2.0, "decode": 1.0},
                                                {"host": 1.0, "decode": 1.0})]
    return out


@pytest.mark.parametrize("name", list(ORACLES))
def test_critpath_decompositions_equal_the_reference(both, name):
    out = _equal(both, _explain, name)
    for rid in out["ids"]:
        res = out[rid]
        assert sum(res["phases"].values()) == pytest.approx(res["wall_s"], rel=1e-6)


# ----------------------------------------------------------------- blackbox


GOLDEN_BUNDLE = {
    "schema": 1, "captured_wall": 1700000000.0, "reason": "stall",
    "request_id": "chatcmpl-golden", "_path": "/ring/bundle-1700000000-0001-stall.json",
    "explain": {"wall_s": 1.25, "phases": {"queue": 0.25, "decode": 0.5, "stall": 0.5},
                "dominant": "decode", "convoy_frac": 0.0, "coverage": 1.0},
    "engine": {"batches": 3, "rows": 5, "joins": 1, "shed": 0, "stream_errors": 1,
               "epoch_stalls": 1},
    "pool": {"pages_total": 64, "pages_free": 60},
}


def _blackbox(m, tmp):
    d = os.path.join(tmp, m.blackbox.__name__)
    box = m.blackbox.BlackBox(d, keep=3, min_interval_s=0.0, p99_mult=3.0)
    for i in range(5):
        box.capture("manual", f"req-{i}", explain=None, timeline=[{"ph": "i", "name": "x"}],
                    events=[{"event": "submitted"}], extra={"engine": {"batches": i}})
    bundles = [m.blackbox.load_bundle(p) for p in box.bundles()]
    for b in bundles:
        b.pop("_path", None)
    outliers = [box.observe_latency(v) for v in [0.1] * 40 + [0.2, 1.0]]
    limited = m.blackbox.BlackBox(d + "-limited", keep=8, min_interval_s=3600.0)
    got = [limited.capture("stall", "a") is not None, limited.capture("epoch-error", "b")]
    errors = []
    for kw in ({"keep": 0}, {"min_interval_s": -1}):
        try:
            m.blackbox.BlackBox(d, **kw)
        except ValueError as e:
            errors.append(str(e))
    diag = []
    for reason, phases in (("stall", None), ("latency-outlier", {"stall": 2.0, "decode": 1.0}),
                           ("latency-outlier", {"convoy": 2.0, "stall": 0.005}),
                           ("slo-ttft", {"queue": 2.0, "decode": 1.0}),
                           ("latency-outlier", {"wire": 2.0, "decode": 1.0}),
                           ("failover", None), ("shed", None), ("manual", None)):
        exp = None if phases is None else {"wall_s": sum(phases.values()), "phases": phases,
                                           "dominant": m.critpath.dominant(phases),
                                           "convoy_frac": 0.0, "coverage": 1.0}
        diag.append(m.blackbox.diagnose({"schema": 1, "reason": reason, "request_id": "x",
                                         "explain": exp}))
    return {"bundles": bundles, "stats": box.stats(), "outliers": outliers,
            "limited": [got[0], got[1] is None, limited.stats()], "errors": errors,
            "diagnose": diag, "report": m.blackbox.render_report(GOLDEN_BUNDLE),
            "report_bundle": m.blackbox.render_report(bundles[-1])}


def test_blackbox_bundles_equal_the_reference(both, tmp_path):
    out = both(_blackbox, str(tmp_path))
    for res in out:  # the bundle rings' directories differ; nothing else may
        res["stats"].pop("dir", None)
        res["limited"][2].pop("dir", None)
    assert out[1] == out[0]
    assert len(out[1]["bundles"]) == 3 and out[1]["outliers"][-1] is True


# ---------------------------------------------------------------------- slo


def _slo(m):
    reg = m.metrics.registry
    obj = m.slo.SloObjectives(ttft_ms=100.0, ttft_target=0.9, deadline_rate=0.9)
    tr = m.slo.SloTracker(obj, fast_window_s=10.0, slow_window_s=60.0)
    for i in range(20):
        tr.observe_ttft("a", 0.05 if i % 4 else 0.5)
        tr.observe_finish("a", "stop" if i % 3 else "deadline", tokens=5, had_deadline=True,
                          got_first_token=True)
    tr.observe_refusal("b", "shed")
    tr.observe_ttft("b", 0.01)
    adj = tr.adjustments()
    tr.refresh_metrics()
    lines = [ln for ln in reg.expose().splitlines() if ln.startswith("cake_slo")]
    flight = [e for e in m.metrics.flight.snapshot() if e["event"] == "slo-burn"]
    return {"adj": adj, "snap": tr.snapshot(), "gauges": lines,
            "burn": [{k: v for k, v in e.items() if k not in ("ts", "mono")} for e in flight]}


def test_slo_gauges_and_burn_events_equal_the_reference(both, monkeypatch):
    for pkg in PACKAGES:
        m = importlib.import_module(f"{pkg}.utils.metrics")
        monkeypatch.setattr(m, "registry", m.MetricsRegistry())
        monkeypatch.setattr(m, "flight", m.FlightRecorder())
    out = _equal(both, _slo)
    assert out["gauges"] and out["burn"]
