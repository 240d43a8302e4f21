"""The port's continuous scheduler (``ServeConfig(scheduler="continuous")``,
runtime/serving.py) on the CPU, against its own epoch scheduler.

A tiny checkpoint (2 layers, written by the JAX package, carried across by
the port's loader) is served at max_seq 256 with pages of 16. Token ids are
compared for equality, never closeness:

  * continuous equals epoch, dense and paged, plain and with the prefix
    cache, greedy and seeded sampled, with joins;
  * under page pressure (a pool of 14 pages) the continuous engine
    preempts and restores, and its streams, finish reasons and token counts
    equal the unpressured run's, with no truncation, no spill left and every
    page back; the epoch scheduler still truncates there; every fusion
    keeps the streams;
  * a restore writes back exactly what the spill copied (key, ring, ring
    index, pending token) and the re-prefilled K/V equals, to the bit, the
    K/V the lane held before the spill, position by position;
  * the victim is the lowest priority; a spill that cannot return inside its
    segment seeds the next one; cancel and stop reach spilled lanes;
  * ``StepBudget`` equals the JAX package's; a small step budget defers
    joins and changes no stream; a second continuous round adds no decode
    graph key; the CLI flags and the API's ``priority`` field.

tests/test_torch_continuous_jax.py holds the same scenarios to the JAX
package's continuous engine.
"""

import http.client
import itertools
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cake_tpu.io.safetensors_io import save_tiny_checkpoint as jax_save_tiny_checkpoint
from cake_tpu.models.llama import model as JM
from cake_tpu.models.llama.config import LlamaConfig as JaxConfig
from cake_tpu.runtime.admission import StepBudget as JaxStepBudget
from cake_tpu_torch.io.safetensors_io import load_params
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import load_tokenizer
from cake_tpu_torch.runtime import serving
from cake_tpu_torch.runtime.admission import StepBudget
from cake_tpu_torch.runtime.api import ApiServer
from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)

MAX_SEQ = 256
PAGE = 16
SERVE = dict(max_batch=4, decode_chunk_size=4, admission_window=0.05)
MODES = {
    "dense": {},
    "paged": {"kv_mode": "paged", "page_size": PAGE},
    "prefix": {"kv_mode": "paged", "page_size": PAGE, "prefix_cache": True},
}
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)
SAMPLED = dict(temperature=0.8, top_k=20, repeat_penalty=1.1, repeat_last_n=8)
KNOBS = {"greedy": GREEDY, "sampled": SAMPLED}
# (user turn, max_tokens, seed): the first two open the segment; the last two
# are submitted once the first stream has its first token, and join.
MIXED = [
    ("short", 24, 7),
    ("a medium prompt with some more words in it", 24, 2**32 + 3),
    ("the long prompt of this batch, padded out with further words so its bucket is "
     "clearly taller than the short one's", 10, 11),
    ("late joiner", 8, -5),
]
# Two long prompts, 48 tokens each: 14 pages cannot hold both to the end.
PRESSURE = ["alpha prompt padded out to be long " * 2, "row two also made quite long here " * 2]
SMALL_POOL, BIG_POOL = 14, 64


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = JaxConfig.tiny(num_hidden_layers=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(31), jnp.float32)
    path = tmp_path_factory.mktemp("tiny_continuous")
    jax_save_tiny_checkpoint(path, params, cfg)
    return path


@pytest.fixture(scope="module")
def port_model(ckpt):
    cfg = LlamaConfig.from_model_dir(ckpt)
    return cfg, load_params(ckpt, cfg, torch.float32, "cpu"), load_tokenizer(ckpt)


def make_engine(port_model, max_seq=MAX_SEQ, **kw):
    cfg, params, tok = port_model
    return BatchEngine(cfg, params, tok, max_seq_len=max_seq, cache_dtype=torch.float32,
                       serve=ServeConfig(**{**SERVE, **kw}), device="cpu")


def sampling(knobs: dict, seed: int) -> SamplingConfig:
    return SamplingConfig(seed=seed, **knobs)


def mixed_scenario(eng, knobs: dict) -> list[list[int]]:
    """Submit MIXED's first two before start(), start, wait for the first
    stream's first token, submit the other two (they join). Returns the
    id streams; the engine is idle after."""
    handles = [eng.submit([Message.user(u)], n, sampling(knobs, seed))
               for u, n, seed in MIXED[:2]]
    eng.start()
    first = handles[0].tokens()
    head = [next(first).id]
    handles += [eng.submit([Message.user(u)], n, sampling(knobs, seed))
                for u, n, seed in MIXED[2:]]
    out = [head + [t.id for t in first]] + [[t.id for t in h.tokens()] for h in handles[1:]]
    assert eng.wait_idle(30.0)
    return out


def pressure_run(eng, knobs: dict, n_tokens: int = 48, priorities=(None, None)):
    """PRESSURE's two requests submitted before start(): one admission.
    Returns (streams, finish reasons, stats after the engine went idle)."""
    handles = [eng.submit([Message.user(p)], n_tokens, sampling(knobs, 7 + i), priority=pr)
               for i, (p, pr) in enumerate(zip(PRESSURE, priorities))]
    eng.start()
    out = [[t.id for t in h.tokens()] for h in handles]
    assert eng.wait_idle(30.0)
    return out, [h.finish_reason for h in handles], eng.snapshot()


def assert_pool_whole(eng, snap: dict) -> None:
    """No spill left, and every page not held by the prefix cache is free."""
    assert snap["spilled"] == 0 and not eng._spilled
    held = snap["prefix"]["pages"] if "prefix" in snap else 0
    assert snap["pages_free"] == snap["pages_total"] - held


# ------------------------------------------------- continuous against epoch


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("mode", list(MODES))
def test_continuous_equals_epoch(port_model, mode, knobs):
    got, joins = {}, {}
    for sched in ("epoch", "continuous"):
        eng = make_engine(port_model, scheduler=sched, **MODES[mode])
        try:
            got[sched] = mixed_scenario(eng, KNOBS[knobs])
            joins[sched] = eng.stats["joins"]
        finally:
            eng.stop()
    assert got["continuous"] == got["epoch"]
    assert all(len(ids) > 1 for ids in got["continuous"])
    assert joins["epoch"] >= 1 and joins["continuous"] >= 1


def test_second_continuous_round_adds_no_decode_graph(port_model):
    """A continuous round on a warm engine (a segment start, joins, lane
    churn, and a pressured round's spills and restores) builds no decode
    chunk an earlier round did not: on the card each key is one captured
    graph."""
    eng = make_engine(port_model, scheduler="continuous", max_pages=SMALL_POOL,
                      **MODES["prefix"])
    try:
        mixed = mixed_scenario(eng, GREEDY)
        keys = set(eng.backend._chunks)
        assert mixed_scenario(eng, GREEDY) == mixed
        assert set(eng.backend._chunks) == keys
        out, _, snap = pressure_run(eng, GREEDY)
        keys = set(eng.backend._chunks)
        assert pressure_run(eng, GREEDY)[0] == out
        assert set(eng.backend._chunks) == keys
        assert eng.stats["preemptions"] >= 2 and eng.stats["restores"] >= 2
    finally:
        eng.stop()


# ------------------------------------------------- preemption and restore


@pytest.fixture(scope="module")
def unpressured(port_model):
    """The pressure scenario on a pool that holds it: the reference streams."""
    out = {}
    for prefix, knobs in itertools.product((False, True), KNOBS):
        eng = make_engine(port_model, scheduler="continuous", max_pages=BIG_POOL,
                          **MODES["prefix" if prefix else "paged"])
        try:
            out[prefix, knobs] = pressure_run(eng, KNOBS[knobs])
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_preempt_restore_equals_unpressured(port_model, unpressured, prefix, knobs):
    want, want_fin, big = unpressured[prefix, knobs]
    eng = make_engine(port_model, scheduler="continuous", max_pages=SMALL_POOL,
                      **MODES["prefix" if prefix else "paged"])
    try:
        got, fin, snap = pressure_run(eng, KNOBS[knobs])
        assert_pool_whole(eng, snap)
    finally:
        eng.stop()
    assert big["preemptions"] == big["restores"] == 0
    assert snap["preemptions"] >= 1 and snap["restores"] >= 1
    assert snap["batches"] == 1  # the spill came back inside its segment
    assert snap["page_truncations"] == big["page_truncations"] == 0
    assert got == want
    assert fin == want_fin


@pytest.mark.parametrize("fusion", ["norm", "ingest,tail", "all"])
def test_preempt_restore_under_every_fusion(port_model, unpressured, fusion):
    """The fused engine preempts and restores to the unfused streams."""
    want = unpressured[True, "sampled"][0]
    eng = make_engine(port_model, scheduler="continuous", max_pages=SMALL_POOL,
                      fusion_impl=fusion, **MODES["prefix"])
    try:
        got, _, snap = pressure_run(eng, SAMPLED)
        assert_pool_whole(eng, snap)
    finally:
        eng.stop()
    assert snap["preemptions"] >= 1 and snap["restores"] >= 1
    assert got == want


def test_epoch_scheduler_still_truncates(port_model, unpressured):
    """The same pool under the epoch scheduler finishes a stream as
    "length" before its budget, as before this scheduler existed."""
    eng = make_engine(port_model, scheduler="epoch", max_pages=SMALL_POOL, **MODES["paged"])
    try:
        got, fin, snap = pressure_run(eng, GREEDY)
        assert_pool_whole(eng, snap)
    finally:
        eng.stop()
    assert snap["page_truncations"] >= 1 and snap["preemptions"] == 0
    assert min(len(ids) for ids in got) < 48
    want = unpressured[False, "greedy"][0]
    assert all(ids == w[: len(ids)] for ids, w in zip(got, want))


def _lane_kv(eng, lane: int, lo: int, hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The K/V of ``lane``'s slots [lo, hi) through its block table:
    [layers, hi - lo, kv heads, head dim] each."""
    table = eng._alloc.block_tables[lane]
    pool = eng.backend._pool
    slots = np.arange(lo, hi)
    pages = torch.as_tensor(table[slots // PAGE], dtype=torch.long)
    offs = torch.as_tensor(slots % PAGE, dtype=torch.long)
    assert (pages >= 0).all()
    return pool.k[:, pages, :, offs].clone(), pool.v[:, pages, :, offs].clone()


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_restore_writes_back_what_the_spill_copied(port_model, monkeypatch, prefix):
    """Spy on ``_spill_lane`` and ``_restore_lane``: the restored lane's key,
    ring, ring index and pending token are the spill's copies, its pad puts
    history[:-1] right before the shared slot, and its re-prefilled K/V over
    that history equals, to the bit, the K/V it held before the spill
    (compared by position in the history)."""
    spills, restores = {}, []
    spill, restore = BatchEngine._spill_lane, BatchEngine._restore_lane

    def spy_spill(self, rows, lane, slot, spill_ctx, reason):
        row = rows[lane]
        n_hist = len(row.history) - 1
        kv = _lane_kv(self, lane, slot - n_hist, slot)
        spill(self, rows, lane, slot, spill_ctx, reason)
        sp = self._spilled.get(row.req.rid)
        if sp is not None:
            spills[id(sp)] = kv

    def spy_restore(self, sp, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, pads_j):
        out = restore(self, sp, lane, rows, slot, tok, kv, keys, ring_j, ring_idx_j, pads_j)
        n_hist = len(sp.row.history) - 1
        restores.append((sp, slot, n_hist, sp.row.history[-1], int(tok[lane]),
                         keys[lane].clone(), ring_j[lane].clone(), int(ring_idx_j[lane]),
                         int(pads_j[lane]), _lane_kv(self, lane, slot - n_hist, slot)))
        return out

    monkeypatch.setattr(BatchEngine, "_spill_lane", spy_spill)
    monkeypatch.setattr(BatchEngine, "_restore_lane", spy_restore)
    eng = make_engine(port_model, scheduler="continuous", max_pages=SMALL_POOL,
                      **MODES["prefix" if prefix else "paged"])
    try:
        pressure_run(eng, SAMPLED)
    finally:
        eng.stop()
    assert restores
    for sp, slot, n_hist, pending, tok, key, ring, ring_idx, pad, (k, v) in restores:
        k0, v0 = spills[id(sp)]
        assert tok == pending
        assert torch.equal(key, torch.as_tensor(sp.key))
        assert torch.equal(ring, torch.as_tensor(sp.ring)) and ring_idx == sp.ring_idx
        assert pad == slot - n_hist
        assert torch.equal(k, k0) and torch.equal(v, v0)


def test_victim_is_the_lowest_priority(port_model, monkeypatch):
    spilled = []
    spill = BatchEngine._spill_lane

    def spy(self, rows, lane, slot, spill_ctx, reason):
        spilled.append((rows[lane].req.rid, reason))
        return spill(self, rows, lane, slot, spill_ctx, reason)

    monkeypatch.setattr(BatchEngine, "_spill_lane", spy)
    eng = make_engine(port_model, scheduler="continuous", max_pages=SMALL_POOL,
                      **MODES["paged"])
    lo = eng.submit([Message.user(PRESSURE[0])], 48, SamplingConfig(**GREEDY), priority=0)
    hi = eng.submit([Message.user(PRESSURE[1])], 48, SamplingConfig(**GREEDY), priority=2)
    eng.start()
    try:
        for h in (lo, hi):
            assert len(list(h.tokens())) == 48
    finally:
        eng.stop()
    assert eng.stats["preemptions"] >= 1
    assert {rid for rid, _ in spilled} == {lo.request_id}


def test_default_priority_applies_to_requests_without_one(port_model):
    eng = make_engine(port_model, scheduler="continuous", default_priority=2)
    eng.submit([Message.user("a")], 2, SamplingConfig(**GREEDY))
    eng.submit([Message.user("b")], 2, SamplingConfig(**GREEDY), priority=0)
    eng.submit([Message.user("c")], 2, SamplingConfig(**GREEDY), priority=9)  # clamped
    assert [r.priority for r in eng._queue] == [2, 0, 2]
    eng.stop()


def test_restore_through_a_spill_seeded_segment(port_model):
    """A spill whose remaining budget no longer fits its segment's capacity
    waits for the segment to drain and seeds the next one: its streams equal
    the unpressured run's across the segment boundary."""

    def run(max_pages):
        eng = make_engine(port_model, max_seq=512, scheduler="continuous", max_pages=max_pages,
                          admission_window=0.1, **MODES["paged"])
        h1 = eng.submit([Message.user(PRESSURE[0])], 140, SamplingConfig(**GREEDY), priority=2)
        h2 = eng.submit([Message.user(PRESSURE[1])], 48, SamplingConfig(**GREEDY), priority=0)
        eng.start()
        try:
            out = ([t.id for t in h1.tokens()], [t.id for t in h2.tokens()])
            assert eng.wait_idle(30.0)
            snap = eng.snapshot()
            assert_pool_whole(eng, snap)
        finally:
            eng.stop()
        return out, snap

    want, big = run(BIG_POOL)
    got, small = run(15)
    assert small["preemptions"] >= 1 and small["restores"] >= 1
    assert small["page_truncations"] == 0
    assert small["batches"] > big["batches"]  # the restore rode a second segment
    assert got == want


# ---------------------------------------------- cancel and stop reach spills


def _forge_spill(eng, text: str):
    """Move a queued request into the spill table as if preempted after its
    first token (the engine is not started)."""
    h = eng.submit([Message.user(text)], 8, SamplingConfig(**GREEDY))
    with eng._cv:
        req = next(iter(eng._queue))
        eng._queue.remove(req)
    row = serving._RowState(req, set(), eng.tokenizer, eng)
    row.push(5)  # the pending token
    with eng._cv:
        eng._spilled[req.rid] = serving._SpilledLane(
            row=row, key=np.zeros(2, np.int64), ring=None, ring_idx=0)
    return h


def test_cancel_reaches_a_spilled_lane(port_model):
    eng = make_engine(port_model, scheduler="continuous", **MODES["paged"])
    h = _forge_spill(eng, "park me")
    assert not eng.wait_idle(0.05)  # a spilled lane is work
    assert eng.cancel(h.request_id)
    assert [t.id for t in h.tokens()] == [5]
    assert h.finish_reason == "cancelled" and eng.stats["cancelled"] == 1
    assert not eng._spilled and eng.wait_idle(0.05)
    assert not eng.cancel(h.request_id)  # idempotent
    eng.stop()


def test_stop_closes_spilled_lanes(port_model):
    eng = make_engine(port_model, scheduler="continuous", **MODES["paged"])
    h = _forge_spill(eng, "never restored")
    eng.stop()
    it = h.tokens()
    assert next(it).id == 5
    with pytest.raises(RuntimeError, match="engine stopped"):
        next(it)
    assert not eng._spilled


def test_stop_mid_run_closes_spilled_lanes(port_model, monkeypatch):
    """A running engine stopped while a lane is spilled (its restores held
    back) closes that stream with the error instead of leaving it open."""
    monkeypatch.setattr(BatchEngine, "_take_restores",
                        lambda self, knobs, rows, slot, cap, budget, tok, kv, *a: kv)
    monkeypatch.setattr(BatchEngine, "_pop_spill_seed", lambda self: [])
    eng = make_engine(port_model, scheduler="continuous", max_pages=SMALL_POOL,
                      **MODES["paged"])
    handles = [eng.submit([Message.user(p)], 48, SamplingConfig(**GREEDY)) for p in PRESSURE]
    eng.start()
    deadline = time.monotonic() + 30
    while not eng._spilled and time.monotonic() < deadline:
        time.sleep(0.005)
    spilled = set(eng._spilled)
    eng.stop()
    assert spilled and not eng._spilled
    for h in handles:
        if h.request_id in spilled:
            with pytest.raises(RuntimeError, match="engine stopped"):
                list(h.tokens())


# ---------------------------------------------------------- the step budget


def test_step_budget_equals_the_jax_step_budget():
    for base, alpha in itertools.product((0, 64, 128, 1000), (0.3, 0.5)):
        port, ref = StepBudget(base, alpha), JaxStepBudget(base, alpha)
        for wall in (None, 0.05, 0.2, 0.01, 0.3):
            if wall is not None:
                port.observe_chunk(wall)
                ref.observe_chunk(wall)
            assert port.chunk_ewma == ref.chunk_ewma
            for burning, slack in itertools.product((False, True), (None, 0.0, 0.1, 1.0, 100.0)):
                assert port.grant(burning, slack) == ref.grant(burning, slack)
    assert (StepBudget.AUTO_TOKENS, StepBudget.MIN_TOKENS, StepBudget.SLACK_CHUNKS) == (
        JaxStepBudget.AUTO_TOKENS, JaxStepBudget.MIN_TOKENS, JaxStepBudget.SLACK_CHUNKS)


def test_small_step_budget_defers_joins_and_keeps_streams(port_model):
    """Two lanes, four requests queued before start(): the last two join
    when the first two finish, at one step. A grant that holds either
    joiner's prompt but not both defers one of them a step, and the streams
    are those of the default grant."""
    cfg, _, tok = port_model
    from cake_tpu_torch.models.llama.chat import encode_dialog

    # The long prompts open the segment, so both short ones end by its slot.
    reqs = [(MIXED[2][0], 24), (MIXED[1][0], 24), (MIXED[0][0], 10), (MIXED[3][0], 8)]
    lengths = [len(tok.encode(encode_dialog([Message.user(u)], cfg.dialog_template)))
               for u, _ in reqs[2:]]
    got, deferrals = {}, {}
    for grant in (0, max(lengths)):
        eng = make_engine(port_model, scheduler="continuous", step_prefill_tokens=grant,
                          max_batch=2, **MODES["paged"])
        try:
            handles = [eng.submit([Message.user(u)], n, SamplingConfig(**GREEDY))
                       for u, n in reqs]
            eng.start()
            got[grant] = [[t.id for t in h.tokens()] for h in handles]
            assert eng.wait_idle(30.0)
            deferrals[grant] = eng.stats["budget_deferrals"]
            assert eng.stats["joins"] == 2 and eng.stats["batches"] == 1
        finally:
            eng.stop()
    assert got[max(lengths)] == got[0]
    assert deferrals[0] == 0 and deferrals[max(lengths)] >= 1


# ------------------------------------------------------------ CLI and API


def test_refusals_and_defaults():
    assert ServeConfig().scheduler == "epoch" and ServeConfig().step_prefill_tokens == 0
    assert ServeConfig(scheduler="continuous").default_priority == 1
    for bad in (dict(scheduler="lockstep"), dict(step_prefill_tokens=-1),
                dict(default_priority=3)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)


def test_cli_parses_the_scheduler_flags():
    from cake_tpu_torch.cli import build_parser, serve_config

    args = build_parser().parse_args([
        "--model", "x", "--api", "127.0.0.1:0", "--api-batch", "4", "--kv-mode", "paged",
        "--scheduler", "continuous", "--step-prefill", "96", "--default-priority", "0"])
    serve = serve_config(args)
    assert (serve.scheduler, serve.step_prefill_tokens, serve.default_priority) == (
        "continuous", 96, 0)
    assert serve.kv_mode == "paged" and serve.prefix_cache and serve.max_batch == 4
    default = serve_config(build_parser().parse_args(["--model", "x", "--api-batch", "2"]))
    assert (default.scheduler, default.step_prefill_tokens, default.default_priority) == (
        "epoch", 0, 1)
    for bad in (["--scheduler", "lockstep"], ["--default-priority", "3"]):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["--model", "x", *bad])


def test_api_priority_field(ckpt, port_model):
    gen = LlamaGenerator.load(ckpt, dtype=torch.float32, max_seq_len=MAX_SEQ,
                              sampling=SamplingConfig(**GREEDY), device="cpu")
    engine = make_engine(port_model, scheduler="continuous", **MODES["paged"])
    seen = []
    submit = engine.submit
    engine.submit = lambda *a, **kw: (seen.append(kw.get("priority")), submit(*a, **kw))[1]
    api = ApiServer(gen, default_max_tokens=4, engine=engine)
    srv = api.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port, timeout=60)
        try:
            conn.request("POST", "/api/v1/chat/completions", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        msg = [{"role": "user", "content": "hello"}]
        status, body = post({"messages": msg, "priority": 3})
        assert status == 400 and "priority" in body["error"]
        status, body = post({"messages": msg, "priority": 0})
        assert status == 200 and body["usage"]["completion_tokens"] == 4
        status, _ = post({"messages": msg})
        assert status == 200
        assert seen == [0, None]  # the engine's default applies to the second
    finally:
        srv.shutdown()
        srv.server_close()
        api.close()
        thread.join(timeout=10)

