"""The port's engine records what the JAX package's engine records.

Both packages' ``BatchEngine`` over one tiny checkpoint
(tests/_continuous_pair.py), every request submitted before ``start()``
with its own id, so both admit, join, defer, spill and restore alike. Each
run gets a fresh metrics registry, flight recorder and timeline ring, and
then the two engines' records are held equal:

  * the registry's counter values (those counting seconds excepted) and
    every histogram's sample counts;
  * the efficiency snapshot's token classes, per-tenant goodput and
    dispatch count;
  * the decision audit, record by record apart from its clock;
  * the request log's lines apart from their timings;
  * the flight recorder's events in order, and the timeline's span and
    instant names (its counter tracks are gauge samples, left out).

Scenarios: the epoch scheduler with two knob groups and a join, dense,
paged and with the prefix cache (a warm second wave); the continuous
scheduler under page pressure (spill, preempt and restore), paged and with
the prefix cache; and a spill-seeded segment.
"""

import importlib
import time

import pytest

import _continuous_pair as P
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

PKG = {"jax": "cake_tpu", "port": "cake_tpu_torch"}
# Timing fields of a request-log line; everything else must be equal.
TIMINGS = {"queue_s", "admit_s", "ttft_s", "tpot_s", "wall_s", "t_wall", "phases", "deadline_s"}


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    return P.packages(P.write_checkpoint(tmp_path_factory.mktemp("tiny_obs_engine")))


def _fresh_records(name: str, monkeypatch):
    pkg = PKG[name]
    m = importlib.import_module(f"{pkg}.utils.metrics")
    monkeypatch.setattr(m, "registry", m.MetricsRegistry())
    monkeypatch.setattr(m, "flight", m.FlightRecorder(capacity=100_000))
    tl = importlib.import_module(f"{pkg}.obs.timeline").timeline
    tl.clear()
    return m, tl


def _records(m, tl, eng) -> dict:
    dump = m.registry.dump()["metrics"]
    counters = {(f["name"], tuple(sorted(s["labels"].items()))): s["value"]
                for f in dump if f["kind"] == "counter" and "seconds" not in f["name"]
                for s in f["series"]}
    hists = {(f["name"], tuple(sorted(s["labels"].items()))): s["count"]
             for f in dump if f["kind"] == "histogram" for s in f["series"]}
    rows_hist = [s["counts"] for f in dump if f["name"] == "cake_batch_rows" for s in f["series"]]
    snap = eng.efficiency.snapshot()
    audit = [{k: v for k, v in d.items() if k != "t"} for d in eng.audit.snapshot()]
    reqlog = [{k: v for k, v in r.items() if k not in TIMINGS} for r in eng.requestlog.snapshot()]
    flight = [(e["event"], e.get("request_id")) for e in m.flight.snapshot()
              if not e["event"].startswith(("jit", "mem"))]
    names = sorted((e["ph"], e["name"]) for e in tl.snapshot()
                   if e["ph"] != "C" and not e["name"].startswith("jit"))
    return {"counters": counters, "hists": hists, "rows_hist": rows_hist,
            "tokens": snap["tokens"], "tenants": snap["tenants"],
            "goodput_tokens": snap["goodput_tokens"], "decisions": snap["decisions"],
            "audit": audit, "reqlog": reqlog, "flight": flight, "names": names,
            "stats": {k: eng.stats[k] for k in ("batches", "rows", "joins", "preemptions",
                                                 "restores", "page_truncations", "prefix_hits",
                                                 "prefix_misses")}}


def _both(packages, monkeypatch, drive, **serve_kw) -> dict:
    out = {}
    for name, pkg in packages.items():
        m, tl = _fresh_records(name, monkeypatch)
        eng = pkg.engine(**serve_kw)
        try:
            drive(pkg, eng)
            # Every epoch ran to its own end before the stop.
            assert pkg.idle(eng) and _epochs_closed(pkg, eng)
        finally:
            eng.stop()
        out[name] = _records(m, tl, eng)
    return out


def _assert_equal(got: dict) -> dict:
    jax_rec, port = got["jax"], got["port"]
    # Every counter the port counts, the reference counts the same; the
    # reference's extra families (its jit and memory watchers) aside.
    for key, value in port["counters"].items():
        assert jax_rec["counters"].get(key) == value, key
    missing = {k for k in jax_rec["counters"] if k not in port["counters"]
               and not k[0].startswith(("cake_jit", "cake_hbm", "cake_mem"))}
    assert not missing
    for key, count in port["hists"].items():
        assert jax_rec["hists"].get(key) == count, key
    for key in ("rows_hist", "tokens", "tenants", "goodput_tokens", "decisions", "audit",
                "reqlog", "flight", "names", "stats"):
        assert port[key] == jax_rec[key], key
    return port


def _epoch_drive(pkg, eng):
    """Two knob groups: five greedy requests of tenant "a", then a sampled
    one of tenant "b". The first epoch admits four greedy ones (the fifth
    waits for a lane, the sampled one defers on its knobs), the fifth joins
    the lane the short one frees, the sampled one bounds the epoch and runs
    in one of its own."""
    greedy = pkg.sampling(**P.KNOBS["greedy"])
    sampled = pkg.sampling(seed=7, **P.KNOBS["sampled"])
    reqs = [("short", 3, greedy, "a"), ("a medium prompt with some more words", 12, greedy, "a"),
            ("third greedy request here", 12, greedy, "a"), ("fourth", 12, greedy, "a"),
            ("fifth joins later", 6, greedy, "a"), ("sampled one", 6, sampled, "b")]
    hs = [eng.submit([pkg.message.user(u)], n, s, request_id=f"r{i}", tenant=t)
          for i, (u, n, s, t) in enumerate(reqs)]
    eng.start()
    for h in hs:
        list(h.tokens())


def _epochs_closed(pkg, eng, timeout: float = 30.0) -> bool:
    """Every started epoch has ended: its span is in the timeline ring (a
    stream closes at its last token, before its epoch's end)."""
    tl = importlib.import_module(
        f"{PKG['jax' if pkg.__class__.__name__ == 'JaxPackage' else 'port']}.obs.timeline"
    ).timeline
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ended = sum(e["ph"] == "X" and e["name"] in ("epoch", "segment") for e in tl.snapshot())
        if ended >= eng.stats["batches"]:
            return True
        time.sleep(0.005)
    return False


@pytest.mark.parametrize("mode", list(P.MODES))
def test_epoch_records_equal_the_jax_engine(packages, monkeypatch, mode):
    def drive(pkg, eng):
        _epoch_drive(pkg, eng)
        if mode == "prefix":  # a warm wave over the cached chains, on an idle engine
            assert pkg.idle(eng) and _epochs_closed(pkg, eng)
            hs = [eng.submit([pkg.message.user("a medium prompt with some more words")], 4,
                             pkg.sampling(**P.KNOBS["greedy"]), request_id="w0")]
            for h in hs:
                list(h.tokens())

    port = _assert_equal(_both(packages, monkeypatch, drive, **P.MODES[mode]))
    actions = {(d["action"], d["cause"]) for d in port["audit"]}
    assert {("admit", "fair_order"), ("defer", "knob_incompatible"),
            ("join", "fair_order")} <= actions
    assert port["tokens"]["completed"] == sum(r["completion_tokens"] for r in port["reqlog"])
    assert len(port["reqlog"]) == 6 + (mode == "prefix")
    if mode == "prefix":
        assert port["stats"]["prefix_hits"] >= 1


@pytest.mark.parametrize("mode", ["paged", "prefix"])
def test_pressured_continuous_records_equal_the_jax_engine(packages, monkeypatch, mode):
    """Spills and restores under page pressure: the preempt, spill and
    restore verdicts and their flight events and instants are the
    reference's."""

    def drive(pkg, eng):
        hs = [eng.submit([pkg.message.user(p)], 48, pkg.sampling(**P.KNOBS["greedy"]),
                         request_id=f"p{i}") for i, p in enumerate(P.PRESSURE)]
        eng.start()
        for h in hs:
            list(h.tokens())

    port = _assert_equal(_both(packages, monkeypatch, drive, scheduler="continuous",
                               max_pages=P.SMALL_POOL, **P.MODES[mode]))
    actions = {d["action"] for d in port["audit"]}
    assert {"admit", "restore"} <= actions and actions & {"preempt", "spill"}
    assert ("i", "restored") in port["names"] and ("X", "segment") in port["names"]
    assert ("B", "step") in port["names"] or ("X", "step") in port["names"]
    assert port["stats"]["restores"] >= 1


def test_spill_seeded_segment_records_equal_the_jax_engine(packages, monkeypatch):
    def drive(pkg, eng):
        hs = [eng.submit([pkg.message.user(p)], n, pkg.sampling(**P.KNOBS["greedy"]),
                         request_id=f"s{i}", priority=pr)
              for i, (p, n, pr) in enumerate([(P.PRESSURE[0], 140, 2), (P.PRESSURE[1], 48, 0)])]
        eng.start()
        for h in hs:
            list(h.tokens())

    port = _assert_equal(_both(packages, monkeypatch, drive, max_seq=512,
                               scheduler="continuous", max_pages=15, **P.MODES["paged"]))
    assert port["stats"]["batches"] >= 2 and port["stats"]["restores"] >= 1
