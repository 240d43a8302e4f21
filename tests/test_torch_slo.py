"""The port's SLO tracker (``cake_tpu_torch/obs/slo.py``) against the JAX
package's (``cake_tpu/obs/slo.py``), and its feedback into the port's
engine, on the CPU.

The same hypothesis-generated observations (TTFT samples, finishes of every
reason, refusals) on an injected clock give the same ``snapshot()``,
``burn()`` and ``adjustments()`` in both packages, tenant eviction
included. Then the engine: a burning tenant's fair-queue weight and shed
scale rise and reset when the burn ages out (also for a tenant the tracker
evicted), the continuous step budget doubles while some tenant burns and
quarters under a live stream's deadline slack, a stranded joiner's error
lands in its tenant's SLIs, and ``GET /slo`` and ``/stats`` serve the
snapshot, under both schedulers.
"""

import json
import threading
import urllib.request

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cake_tpu.obs import slo as ref
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.obs import slo as port
from cake_tpu_torch.runtime.admission import StepBudget
from cake_tpu_torch.runtime.api import ApiServer
from cake_tpu_torch.runtime.serving import (
    BatchEngine,
    EngineOverloaded,
    ServeConfig,
    StreamHandle,
    _fail_request,
    _Request,
)

TENANTS = ["gold", "silver", "storm", "x"]
REASONS = ["stop", "length", "deadline", "error", "cancelled"]

slo_ops = st.lists(st.one_of(
    st.tuples(st.just("ttft"), st.sampled_from(TENANTS), st.floats(0.0, 2.0, allow_nan=False)),
    st.tuples(st.just("finish"), st.sampled_from(TENANTS), st.sampled_from(REASONS),
              st.integers(0, 50), st.booleans(), st.booleans()),
    st.tuples(st.just("refusal"), st.sampled_from(TENANTS), st.sampled_from(["shed", "quota"])),
    st.tuples(st.just("wait"), st.floats(0.0, 40.0, allow_nan=False)),
    st.tuples(st.just("read"), st.sampled_from(TENANTS)),
), max_size=60)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(ttft_ms=st.sampled_from([0.0, 100.0, 500.0]), target=st.sampled_from([0.9, 0.99]),
       deadline_rate=st.sampled_from([0.0, 0.8]), windows=st.sampled_from([(10.0, 60.0),
                                                                          (30.0, 30.0)]),
       max_tenants=st.sampled_from([2, 256]), ops=slo_ops)
def test_slo_tracker_equals_the_reference(ttft_ms, target, deadline_rate, windows, max_tenants,
                                          ops):
    t = [5000.0]
    clock = lambda: t[0]  # noqa: E731
    kw = dict(fast_window_s=windows[0], slow_window_s=windows[1], max_tenants=max_tenants,
              time_fn=clock)
    a = ref.SloTracker(ref.SloObjectives(ttft_ms, target, deadline_rate), **kw)
    b = port.SloTracker(port.SloObjectives(ttft_ms, target, deadline_rate), **kw)
    for op in ops:
        if op[0] == "ttft":
            a.observe_ttft(op[1], op[2])
            b.observe_ttft(op[1], op[2])
        elif op[0] == "finish":
            kwargs = dict(tokens=op[3], had_deadline=op[4], got_first_token=op[5])
            a.observe_finish(op[1], op[2], **kwargs)
            b.observe_finish(op[1], op[2], **kwargs)
        elif op[0] == "refusal":
            a.observe_refusal(op[1], op[2])
            b.observe_refusal(op[1], op[2])
        elif op[0] == "wait":
            t[0] += op[1]
        else:
            assert b.burn(op[1]) == a.burn(op[1])
            assert b.adjustments() == a.adjustments()
    assert b.snapshot() == a.snapshot()
    assert b.adjustments() == a.adjustments()


def test_objectives_validate_as_the_reference():
    for bad in (dict(ttft_ms=-1), dict(ttft_target=1.0), dict(ttft_target=0.0),
                dict(deadline_rate=1.0), dict(deadline_rate=-0.1)):
        with pytest.raises(ValueError):
            ref.SloObjectives(**bad)
        with pytest.raises(ValueError):
            port.SloObjectives(**bad)
    with pytest.raises(ValueError, match="slo windows"):
        port.SloTracker(fast_window_s=10.0, slow_window_s=5.0)
    with pytest.raises(ValueError, match="slo_ttft"):
        ServeConfig(slo_ttft_target=2.0)
    with pytest.raises(ValueError, match="slo windows"):
        ServeConfig(slo_fast_window_s=0.0)


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def tiny():
    config = LlamaConfig.tiny(num_hidden_layers=2)
    params = M.init_params(config, torch.Generator().manual_seed(2), torch.float32, "cpu")
    return config, params


def _engine(tiny, scheduler, **kw):
    config, params = tiny
    serve = ServeConfig(max_batch=2, decode_chunk_size=4, scheduler=scheduler,
                        slo_ttft_ms=100.0, slo_ttft_target=0.9, slo_deadline_rate=0.9,
                        slo_fast_window_s=10.0, slo_slow_window_s=60.0, **kw)
    return BatchEngine(config, params, ByteTokenizer(), max_seq_len=64,
                       cache_dtype=torch.float32, serve=serve, device="cpu")


SCHEDULERS = ["epoch", "continuous"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_engine_feedback_applies_weights_and_shed_scale(tiny, scheduler):
    eng = _engine(tiny, scheduler)
    for _ in range(5):
        eng.slo.observe_ttft("abuser", 5.0)  # 50x over the objective
    eng._apply_slo_feedback(force=True)
    assert eng._queue.weight("abuser") > 1.0 and eng._slo_shed_scale["abuser"] > 1.0
    # The scaled estimate sheds the burning tenant's doomed deadline while
    # the same deadline from a calm tenant still queues.
    eng._wait_est.observe(1.0)
    with pytest.raises(EngineOverloaded):
        eng._maybe_shed(deadline_s=2.0, tenant="abuser")
    eng._maybe_shed(deadline_s=2.0, tenant="calm")
    # Burning doubles the continuous step budget.
    assert eng._grant_step_budget([None]) == 2 * StepBudget.AUTO_TOKENS
    eng.slo._time = lambda: 1e9  # everything ages out
    eng._apply_slo_feedback(force=True)
    assert eng._queue.weight("abuser") == 1.0 and "abuser" not in eng._slo_shed_scale
    assert eng._grant_step_budget([None]) == StepBudget.AUTO_TOKENS
    eng.stop()


def test_engine_resets_weight_of_tracker_evicted_tenant(tiny):
    eng = _engine(tiny, "epoch")
    for _ in range(5):
        eng.slo.observe_ttft("ghost", 5.0)
    eng._apply_slo_feedback(force=True)
    assert eng._queue.weight("ghost") > 1.0
    for i in range(eng.slo.max_tenants + 5):
        eng.slo.observe_ttft(f"filler{i}", 0.001)
    assert "ghost" not in eng.slo.snapshot()["tenants"]
    eng._apply_slo_feedback(force=True)
    assert eng._queue.weight("ghost") == 1.0
    eng.stop()


def test_feedback_off_leaves_admission_alone(tiny):
    eng = _engine(tiny, "epoch", slo_feedback=False)
    for _ in range(5):
        eng.slo.observe_ttft("abuser", 5.0)
    eng._apply_slo_feedback(force=True)
    assert eng._queue.weight("abuser") == 1.0 and not eng._slo_shed_scale
    eng.stop()


def test_step_budget_quarters_under_deadline_slack(tiny):
    import time

    eng = _engine(tiny, "continuous")
    eng._step_budget.observe_chunk(0.5)  # 8 chunk walls = 4 s of slack
    row = type("Row", (), {})()
    row.req = type("Req", (), {"deadline": time.monotonic() + 1.0})()
    assert eng._grant_step_budget([row, None]) == StepBudget.AUTO_TOKENS // 4
    row.req.deadline = time.monotonic() + 60.0
    assert eng._grant_step_budget([row, None]) == StepBudget.AUTO_TOKENS
    eng.stop()


def test_fail_request_feeds_error_sli(tiny):
    import time

    eng = _engine(tiny, "epoch")
    req = _Request([1, 2, 3], 4, SamplingConfig(), StreamHandle(3, "rid-x"), rid="rid-x",
                   tenant="victim", deadline=time.monotonic() + 9)
    _fail_request(req, eng)
    w = eng.slo.snapshot()["tenants"]["victim"]["fast"]
    assert w["error_rate"] == 1.0 and w["burn"]["ttft"] > 0  # a tokenless error is a TTFT miss
    assert req.handle.finish_reason == "error"
    eng.stop()


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_engine_streams_land_in_their_tenants_slis(tiny, scheduler):
    config, params = tiny
    eng = _engine(tiny, scheduler)
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    from cake_tpu_torch.models.llama.chat import Message

    hs = [eng.submit([Message.user(f"hi {i}")], 3, greedy, tenant=t, deadline_s=60.0)
          for i, t in enumerate(["gold", "gold", "silver"])]
    eng.start()
    for h in hs:
        assert len([t.id for t in h.tokens()]) == 3
    assert eng.wait_idle(30.0)
    snap = eng.slo.snapshot()["tenants"]
    assert snap["gold"]["fast"]["requests"] == 2 and snap["silver"]["fast"]["requests"] == 1
    assert snap["gold"]["fast"]["deadline_hit_rate"] == 1.0
    assert snap["gold"]["fast"]["goodput_tok_s"] == pytest.approx(6 / 10.0)
    eng.stop()


def test_slo_endpoint(tiny):
    config, params = tiny
    eng = _engine(tiny, "epoch")
    eng.slo.observe_finish("storm", "deadline", had_deadline=True, got_first_token=False)
    eng.slo.observe_ttft("gold", 0.01)
    eng.slo.observe_finish("gold", "stop", tokens=5)
    step = LocalForwardStep(config, params, max_seq_len=64, cache_dtype=torch.float32,
                            device="cpu")
    gen = LlamaGenerator(config, step, ByteTokenizer(), SamplingConfig())
    api = ApiServer(gen, default_max_tokens=8, engine=eng)
    server = api.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/slo", timeout=10) as r:
            body = json.load(r)
        assert body["objectives"]["ttft_ms"] == 100.0
        assert body["windows"] == {"fast_s": 10.0, "slow_s": 60.0}
        assert body["tenants"]["storm"]["burn_rate"] > 0
        assert body["tenants"]["gold"]["burn_rate"] == 0.0
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            stats = json.load(r)
        assert stats["slo"]["tenants"].keys() == body["tenants"].keys()
        assert "tenants" in stats and stats["engine"]["deadline_expired"] == 0
    finally:
        server.shutdown()
        server.server_close()
        api.close()
        thread.join(10)
