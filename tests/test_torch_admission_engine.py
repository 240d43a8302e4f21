"""Admission on the port's engine (``cake_tpu_torch/runtime/serving.py``)
on the CPU, under the epoch and the continuous scheduler: the invariants
``tests/test_admission.py`` pins on the JAX package's engine, re-pinned on
the port's tiny engine, then the stall watchdog and the API.

  * quotas: per-tenant 429s, a stream cap freed by a finished stream, a shed
    that refunds its quota charge;
  * fairness: a tenant's flood cannot push another tenant's request behind
    it, and with ``fair_queue=False`` the same flood does;
  * deadlines: a queued request expires with no page mapped, a running
    stream finishes ``"deadline"`` at a chunk boundary with its pages back
    and a co-batched stream untouched, a spilled lane past its deadline is
    never restored, a default deadline applies, a doomed deadline sheds;
  * shedding: the queue-depth gate (low priority at half the depth, its
    Retry-After doubled) and the page gate, which counts cold prefix-cache
    pages as free; the backpressure watermark;
  * the watchdog: a decode dispatch that stalls is abandoned within the
    bound and its epoch's streams finish ``"error"``; once released, the
    stalled thread writes garbage into every buffer it captured (its KV,
    its operands, every decode chunk's static buffers) while the next wave
    runs, and that wave's streams and the KV its lanes read equal a fresh
    engine's bitwise; dense, paged and with the prefix cache, and over TCP;
    a decode that stalls inside the real dispatch, after its storage check
    passed, builds or runs its chunk on waking while the next epoch is live,
    and that epoch's streams equal a fresh engine's;
  * the API: 400s before any header, a 429 and a 503 with Retry-After,
    ``POST /api/v1/cancel``.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.runtime.admission import DEFAULT_TENANT, QuotaExceeded
from cake_tpu_torch.runtime.api import ApiServer
from cake_tpu_torch.runtime.serving import BatchEngine, EngineOverloaded, ServeConfig

GREEDY = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
SAMPLED = SamplingConfig(temperature=0.7, top_k=5, repeat_penalty=1.0, seed=3)
MAX_SEQ = 128
PAGE = 16
SCHEDULERS = ["epoch", "continuous"]
MODES = {
    "dense": {},
    "paged": {"kv_mode": "paged", "page_size": PAGE},
    "prefix": {"kv_mode": "paged", "page_size": PAGE, "prefix_cache": True},
}


@pytest.fixture(scope="module")
def tiny():
    config = LlamaConfig.tiny(num_hidden_layers=2)
    return config, M.init_params(config, torch.Generator().manual_seed(31), torch.float32, "cpu")


def make_engine(tiny, *, start=True, max_seq=MAX_SEQ, **serve_kw):
    config, params = tiny
    serve_kw.setdefault("max_batch", 4)
    serve_kw.setdefault("decode_chunk_size", 4)
    serve_kw.setdefault("admission_window", 0.02)
    eng = BatchEngine(config, params, ByteTokenizer(), max_seq_len=max_seq,
                      cache_dtype=torch.float32, serve=ServeConfig(**serve_kw), device="cpu")
    if start:
        eng.start()
    return eng


def collect(handle) -> list[int]:
    return [t.id for t in handle.tokens()]


def slow_decode(eng, delay_s: float):
    """Every decode chunk sleeps ``delay_s`` first (a CPU chunk's time is
    noise; deadlines need chunks that last)."""
    real = eng.backend.decode

    def decode(*a, **kw):
        time.sleep(delay_s)
        return real(*a, **kw)

    eng.backend.decode = decode


def wait_batches(eng, n: int = 1) -> None:
    deadline = time.monotonic() + 20.0
    while eng.stats["batches"] < n and time.monotonic() < deadline:
        time.sleep(0.002)
    assert eng.stats["batches"] >= n, "the epoch never started"


def pool_whole(eng) -> bool:
    alloc = eng.backend.allocator
    held = eng._prefix.stats()["pages"] if eng._prefix is not None else 0
    return alloc.pages_free == alloc.pages_total - held


# ------------------------------------------------------------------ quotas


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_engine_quota_rate_limits_per_tenant(tiny, scheduler):
    eng = make_engine(tiny, start=False, scheduler=scheduler, tenant_rate=10.0, tenant_burst=30.0)
    msgs = [Message.user("quota limited prompt")]
    eng.submit(msgs, 16, GREEDY, tenant="abuser")
    with pytest.raises(QuotaExceeded) as ei:
        eng.submit(msgs, 16, GREEDY, tenant="abuser")
    assert ei.value.retry_after_s > 0 and ei.value.kind == "rate"
    assert eng.stats["quota_refusals"] == 1
    eng.submit(msgs, 16, GREEDY, tenant="polite")
    eng.submit(msgs, 16, GREEDY)
    stats = eng.tenant_stats()
    assert stats["abuser"]["quota_refusals"] == 1 and stats["polite"]["quota_refusals"] == 0
    assert stats[DEFAULT_TENANT]["queued"] == 1
    eng.stop()


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_engine_stream_cap_releases_on_finish(tiny, scheduler):
    eng = make_engine(tiny, scheduler=scheduler, tenant_streams=1)
    try:
        h = eng.submit([Message.user("capped")], 2, GREEDY, tenant="t")
        with pytest.raises(QuotaExceeded) as ei:
            eng.submit([Message.user("capped")], 2, GREEDY, tenant="t")
        assert ei.value.kind == "streams"
        collect(h)
        deadline = time.monotonic() + 5.0
        while True:  # the handle's close hook freed the slot
            try:
                h2 = eng.submit([Message.user("capped")], 2, GREEDY, tenant="t")
                break
            except QuotaExceeded:
                assert time.monotonic() < deadline, "the quota slot never came back"
                time.sleep(0.01)
        assert len(collect(h2)) == 2
    finally:
        eng.stop()


def test_shed_refunds_quota_charge(tiny):
    eng = make_engine(tiny, start=False, tenant_rate=10.0, tenant_burst=200.0,
                      shed_queue_depth=1)
    msgs = [Message.user("refund probe")]
    eng.submit(msgs, 16, GREEDY, tenant="t")  # queued: depth 1
    after_one = eng.tenant_meter.snapshot()["t"]
    for _ in range(3):
        with pytest.raises(EngineOverloaded):
            eng.submit(msgs, 16, GREEDY, tenant="t")
    snap = eng.tenant_meter.snapshot()["t"]
    assert snap["bucket_level"] >= after_one["bucket_level"]
    assert snap["tokens"] == pytest.approx(after_one["tokens"]) and snap["active_streams"] == 1
    assert eng.stats["shed"] == 3
    eng.stop()


# ---------------------------------------------------------------- fairness


def _storm_finish_order(tiny, fair: bool, scheduler: str) -> int:
    """A plug stream holding the epoch, then (as one group) an abusive
    flood of 6 and one compliant request: how many abuser streams finished
    before the compliant one."""
    eng = make_engine(tiny, max_batch=2, fair_queue=fair, scheduler=scheduler)
    done: list[str] = []
    lock = threading.Lock()

    def consume(tag, h):
        collect(h)
        with lock:
            done.append(tag)

    threads = []
    try:
        plug = eng.submit([Message.user("plug stream holding the epoch")], 40, GREEDY,
                          tenant="plug")
        threads.append(threading.Thread(target=consume, args=("plug", plug), daemon=True))
        threads[-1].start()
        wait_batches(eng)
        with eng._cv:
            handles = [("abuser", eng.submit([Message.user(f"abusive flood request {i}")], 3,
                                             GREEDY, tenant="abuser")) for i in range(6)]
            handles.append(("compliant", eng.submit([Message.user("one compliant request")], 3,
                                                    GREEDY, tenant="compliant")))
        for tag, h in handles:
            threads.append(threading.Thread(target=consume, args=(tag, h), daemon=True))
            threads[-1].start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads), "a stream hung"
    finally:
        eng.stop()
    order = [t for t in done if t != "plug"]
    return order.index("compliant")


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_fair_queue_ab_flood_cannot_starve_compliant_tenant(tiny, scheduler):
    assert _storm_finish_order(tiny, True, scheduler) <= 2
    assert _storm_finish_order(tiny, False, scheduler) == 6


# --------------------------------------------------------------- deadlines


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_queued_deadline_expires_before_admission_no_pages(tiny, scheduler):
    """It cannot join the running epoch (other knobs), expires at a chunk
    boundary's sweep, and never maps a page."""
    eng = make_engine(tiny, scheduler=scheduler, kv_mode="paged", page_size=PAGE, max_batch=2)
    mapped = []
    real_map = eng.backend.allocator.map_range

    def map_range(lane, lo, hi):
        mapped.append((lane, lo, hi))
        return real_map(lane, lo, hi)

    eng.backend.allocator.map_range = map_range
    try:
        slow_decode(eng, 0.02)
        plug = eng.submit([Message.user("plug stream holding the epoch")], 24, GREEDY)
        wait_batches(eng)
        n_mapped = len(mapped)
        h = eng.submit([Message.user("doomed request")], 8, SAMPLED, deadline_s=0.03)
        assert collect(h) == [] and h.finish_reason == "deadline" and h.completion_tokens == 0
        # Only the plug's lanes mapped pages while the doomed request waited.
        assert all(lane == 0 for lane, _, _ in mapped[n_mapped:])
        collect(plug)
        assert eng.wait_idle(10.0) and pool_whole(eng)
        assert eng.stats["deadline_expired"] == 1 and eng.stats["batches"] == 1
    finally:
        eng.stop()


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_running_deadline_expires_at_chunk_boundary_frees_pages(tiny, scheduler):
    prompts = ("short co-batched", "long deadline victim")
    eng = make_engine(tiny, start=False, scheduler=scheduler, kv_mode="paged", page_size=PAGE)
    hs = [eng.submit([Message.user(p)], n, GREEDY) for p, n in zip(prompts, (2, 24))]
    eng.start()
    want_short, want_long = [collect(h) for h in hs]
    assert eng.wait_idle(10.0)
    slow_decode(eng, 0.08)
    with eng._cv:
        h_s = eng.submit([Message.user(prompts[0])], 2, GREEDY)
        h_l = eng.submit([Message.user(prompts[1])], 24, GREEDY, deadline_s=0.25)
    try:
        got_short, got_long = collect(h_s), collect(h_l)
        assert got_short == want_short and h_s.finish_reason in ("stop", "length")
        assert h_l.finish_reason == "deadline"
        assert got_long == want_long[: len(got_long)] and 0 < len(got_long) < len(want_long)
        assert eng.wait_idle(10.0) and pool_whole(eng)
        assert eng.stats["deadline_expired"] == 1
    finally:
        eng.stop()


PRESSURE = ["alpha prompt padded out to be long " * 2, "row two also made quite long here " * 2]


def test_spilled_lane_past_its_deadline_is_never_restored(tiny):
    """Two long streams on a pool that cannot hold both to the end: the
    low-priority one is spilled, and its deadline passes while it is
    parked (the test moves it to the moment of the spill): it finishes
    ``"deadline"`` and no restore ever runs."""
    # 92 and 90 prompt tokens: 7 pages each with the reserve, and 14 pages
    # cannot hold both 60 tokens further.
    eng = make_engine(tiny, start=False, max_seq=256, scheduler="continuous", kv_mode="paged",
                      page_size=PAGE, max_pages=14, max_batch=2)
    real_spill = eng._spill_lane
    spilled = []

    def spill(rows, lane, *a, **kw):
        req = rows[lane].req
        real_spill(rows, lane, *a, **kw)
        with eng._cv:
            if req.rid in eng._spilled:
                spilled.append(req.rid)
                req.deadline = time.monotonic() - 1e-3

    eng._spill_lane = spill
    hs = [eng.submit([Message.user(p)], 60, GREEDY, priority=pr, deadline_s=600.0)
          for p, pr in zip(PRESSURE, (1, 0))]
    eng.start()
    try:
        got = [collect(h) for h in hs]
        assert eng.wait_idle(10.0)
        assert spilled == [hs[1].request_id]
        assert hs[1].finish_reason == "deadline" and 0 < len(got[1]) < 60
        assert hs[0].finish_reason == "length" and len(got[0]) == 60
        assert eng.stats["restores"] == 0 and eng.stats["deadline_expired"] == 1
        assert pool_whole(eng) and not eng._spilled
    finally:
        eng.stop()


def test_a_late_spill_is_not_seeded(tiny):
    """A spill past its deadline never seeds a segment either."""
    from test_torch_continuous import _forge_spill

    eng = make_engine(tiny, start=False, scheduler="continuous", kv_mode="paged", page_size=PAGE)
    h = _forge_spill(eng, "parked past its deadline")
    with eng._cv:
        next(iter(eng._spilled.values())).row.req.deadline = time.monotonic() - 1.0
    eng.start()
    try:
        assert collect(h) == [5] and h.finish_reason == "deadline"
        assert eng.wait_idle(10.0) and eng.stats["restores"] == 0
    finally:
        eng.stop()


def test_default_deadline_applies_to_bare_submissions(tiny):
    eng = make_engine(tiny, start=False, default_deadline_s=9.0)
    h = eng.submit([Message.user("bare")], 4, GREEDY)
    with eng._cv:
        (req,) = list(eng._queue)
    assert req.deadline == pytest.approx(time.monotonic() + 9.0, abs=1.0)
    assert h.finish_reason == "length" and eng._queue.deadline_count == 1
    eng.stop()


def test_deadline_aware_shed_refuses_doomed_submissions(tiny):
    eng = make_engine(tiny, start=False)
    eng._wait_est.observe(5.0)  # a 1 s deadline is hopeless behind 5 s waits
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit([Message.user("doomed")], 4, GREEDY, deadline_s=1.0)
    assert "deadline" in str(ei.value) and eng.stats["shed"] == 1
    eng.submit([Message.user("fine")], 4, GREEDY)
    eng.stop()


def test_submit_validates_deadline_and_books_default_tenant(tiny):
    eng = make_engine(tiny, start=False)
    for bad in (-1, 0, True, "3"):
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit([Message.user("bad")], 4, GREEDY, deadline_s=bad)
    eng.submit([Message.user("ok")], 4, GREEDY, tenant="  ")
    with eng._cv:
        (req,) = list(eng._queue)
    assert req.tenant == DEFAULT_TENANT
    eng.stop()


# ---------------------------------------------------------------- shedding


def test_queue_depth_sheds_low_priority_at_half_depth(tiny):
    eng = make_engine(tiny, start=False, shed_queue_depth=4, retry_after_s=1.5)
    msgs = [Message.user("queued")]
    for _ in range(2):
        eng.submit(msgs, 4, GREEDY)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(msgs, 4, GREEDY, priority=0)  # depth 2 >= 4 x 0.5
    assert ei.value.retry_after_s == 3.0
    for _ in range(2):
        eng.submit(msgs, 4, GREEDY)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(msgs, 4, GREEDY)  # depth 4
    assert ei.value.retry_after_s == 1.5
    eng.submit(msgs, 4, GREEDY, priority=2)  # high tolerates twice the depth
    assert eng.stats["shed"] == 2 and len(eng._queue) == 5
    eng.stop()


def test_page_gate_counts_cold_cache_pages_as_free(tiny):
    eng = make_engine(tiny, start=False, **MODES["prefix"])
    hs = [eng.submit([Message.user(f"fill the prefix cache with prompt number {i}")], 4, GREEDY)
          for i in range(4)]
    eng.start()
    try:
        for h in hs:
            collect(h)
        assert eng.wait_idle(10.0)
        alloc, cold = eng.backend.allocator, eng._prefix.reclaimable()
        assert cold > 0 and alloc.pages_free < alloc.pages_total
        eng.shed_min_free_pages = alloc.pages_free + cold  # met only with the cold pages
        assert len(collect(eng.submit([Message.user("not shed")], 2, GREEDY))) == 2
        assert eng.wait_idle(10.0)
        eng.shed_min_free_pages = alloc.pages_total + 1
        with pytest.raises(EngineOverloaded, match="KV pages"):
            eng.submit([Message.user("shed")], 2, GREEDY)
    finally:
        eng.stop()


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_backpressure_cancels_an_unread_stream(tiny, scheduler):
    eng = make_engine(tiny, scheduler=scheduler, stream_buffer_tokens=6)
    try:
        h = eng.submit([Message.user("nobody reads me")], 60, GREEDY)
        assert eng.wait_idle(20.0)
        got = collect(h)
        assert h.finish_reason == "cancelled" and 6 <= len(got) < 60
        assert eng.stats["backpressured"] == 1 and eng.stats["cancelled"] == 1
    finally:
        eng.stop()


# ---------------------------------------------------------------- watchdog


def _garbage(t: torch.Tensor) -> None:
    if t.is_floating_point():
        t.fill_(float("nan"))
    else:
        t.fill_(7)


class StallingDecode:
    """Wraps ``backend.decode``: call number ``at`` blocks until the next
    wave's first decode; then, on its abandoned thread, it writes garbage
    into every buffer it captured (its KV, its operands, every decode
    chunk's static buffers and KV) and only then calls the real decode.
    Every later call releases it and waits for those writes first, so they
    land while the next wave's epoch runs. ``reads`` keeps, per decode of
    the wave after the stall, the K/V every live lane reads; with ``at``
    None nothing stalls and every decode's reads are kept."""

    def __init__(self, eng, at: int | None):
        self.eng, self.backend, self.at = eng, eng.backend, at
        self.real = eng.backend.decode
        self.calls = 0
        self.stalled, self.release, self.wrote = (threading.Event() for _ in range(3))
        self.captured: list[torch.Tensor] = []
        self.late_error: BaseException | None = None
        self.reads: list = []
        eng.backend.decode = self

    def __call__(self, kv, tok, slot, pads, keys, ring, ring_idx, n, s):
        self.calls += 1
        if self.calls == self.at:
            caches = kv.values() if isinstance(kv, dict) else [kv]  # the TCP backend's ranges
            self.captured = [t for c in caches for t in (c.k, c.v)]
            self.captured += [tok, pads, keys, ring, ring_idx]
            for c in list(getattr(self.backend, "_chunks", {}).values()):
                self.captured += [c.tok, c.slot, c.ring, c.ring_idx, c.keys, c.ids, c.kv.k,
                                  c.kv.v, *c.extra.values()]
            self.stalled.set()
            self.release.wait(60.0)
            try:
                for t in self.captured:
                    _garbage(t)
            finally:
                self.wrote.set()
            try:
                return self.real(kv, tok, slot, pads, keys, ring, ring_idx, n, s)
            except BaseException as e:  # noqa: BLE001 - kept for the test to read
                self.late_error = e
                raise
        if self.at is None or self.calls > self.at:
            if self.at is not None:
                self.release.set()
                assert self.wrote.wait(60.0)
            self.reads.append(lane_reads(self.eng, kv, pads, slot))
        return self.real(kv, tok, slot, pads, keys, ring, ring_idx, n, s)


def lane_reads(eng, kv, pads, slot: int) -> list:
    """The K/V each lane's attention reads at this decode: slots [pad,
    slot) of its strip, or of its pages through its block table."""
    out = []
    pads = [int(p) for p in pads.tolist()]
    if isinstance(kv, dict):
        return out  # the TCP backend: its KV lives on the workers
    if eng._alloc is None:
        for lane, pad in enumerate(pads):
            out.append((kv.k[:, lane, :, pad:slot].clone(), kv.v[:, lane, :, pad:slot].clone()))
        return out
    page = eng._alloc.page_size
    for lane, pad in enumerate(pads):
        table = eng._alloc.block_tables[lane]
        if not eng._alloc.lane_mapped(lane):
            continue
        pages = [int(table[p]) for p in range(pad // page, -(-slot // page))]
        out.append((lane, kv.k[:, pages].clone(), kv.v[:, pages].clone()))
    return out


WAVE = ["the watchdog wave, prompt one", "prompt two of the wave", "and a third prompt here"]
# The stalled wave's prompts: none extends a chain the first wave cached, so
# the prefix cache's grouping admits all three into the epoch that stalls.
STALLED = ["stalled wave one", "the stalled wave's second", "third of the stalled wave"]


def _wave(eng, n: int = 12, prompts=WAVE) -> list:
    with eng._cv:
        hs = [eng.submit([Message.user(p)], n, GREEDY) for p in prompts]
    out = [collect(h) for h in hs]
    assert eng.wait_idle(20.0)
    return out, [h.finish_reason for h in hs]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_an_abandoned_dispatch_leaves_the_next_epoch_bitwise_fresh(tiny, scheduler, mode):
    stall_s = 0.3
    eng = make_engine(tiny, scheduler=scheduler, epoch_stall_s=stall_s, **MODES[mode])
    fresh = make_engine(tiny, scheduler=scheduler, **MODES[mode])
    stall = None
    try:
        _wave(eng)  # every op's first-call grace is spent
        old_storage = eng.backend._pool if mode != "dense" else eng.backend._kv
        stall = StallingDecode(eng, at=1)
        t0 = time.monotonic()
        with eng._cv:
            hs = [eng.submit([Message.user(p)], 12, GREEDY) for p in STALLED]
        got = [collect(h) for h in hs]
        waited = time.monotonic() - t0
        assert stall.stalled.is_set() and [h.finish_reason for h in hs] == ["error"] * 3
        assert all(len(ids) == 1 for ids in got)  # the first samples, then the stall
        assert waited < stall_s + 5.0
        assert eng.stats["epoch_stalls"] == 1 and eng.stats["stream_errors"] == 3
        assert eng.wait_idle(10.0)
        new_storage = eng.backend._pool if mode != "dense" else eng.backend._kv
        assert new_storage is None  # abandoned until the next epoch allocates
        # The next wave: the stalled thread is released at its first decode.
        streams, reasons = _wave(eng)
        reads_after = stall.reads
        probe = StallingDecode(fresh, at=None)  # records the fresh engine's reads
        want_streams, want_reasons = _wave(fresh)
        assert streams == want_streams and reasons == want_reasons == ["length"] * 3
        assert len(reads_after) == len(probe.reads) > 0
        for a, b in zip(reads_after, probe.reads):
            for x, y in zip(a, b):
                for u, v in zip(x if isinstance(x, tuple) else (x,),
                                y if isinstance(y, tuple) else (y,)):
                    assert torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
        # The woken thread wrote its garbage into the old storage and then
        # was refused (_check_live) before it could run on.
        assert stall.wrote.is_set() and torch.isnan(old_storage.k).all()
        assert isinstance(stall.late_error, RuntimeError) and "abandoned" in str(stall.late_error)
        if mode != "dense":
            assert pool_whole(eng)
    finally:
        if stall is not None:
            stall.release.set()
        eng.stop()
        fresh.stop()


class StallingInside:
    """Stalls decode call number ``at`` INSIDE the backend's real decode,
    after its ``_check_live`` passed: at ``point`` "chunk" (the backend's
    ``_decode_chunk``, where the decode looks up or builds its chunk) or
    "run" (``DecodeChunk.run``, where it runs the chunk's loop; on the card
    the capture and the replay). The next wave's first decode releases it
    and waits until it has run to its end, so it builds, captures and
    writes while the next epoch is live."""

    def __init__(self, eng, monkeypatch, point: str, at: int = 1):
        from cake_tpu_torch.models.llama import fused
        from cake_tpu_torch.runtime import batch_backend

        self.at, self.calls, self.thread = at, 0, None
        self.stalled, self.release, self.done = (threading.Event() for _ in range(3))
        self.late_error: BaseException | None = None
        owner, name = ((batch_backend, "_decode_chunk") if point == "chunk"
                       else (fused.DecodeChunk, "run"))
        inner, outer = getattr(owner, name), eng.backend.decode

        def stalled_inner(*a, **kw):
            if threading.current_thread() is not self.thread:
                return inner(*a, **kw)
            self.stalled.set()
            self.release.wait(60.0)
            try:
                return inner(*a, **kw)
            except BaseException as e:  # noqa: BLE001 - kept for the test to read
                self.late_error = e
                raise
            finally:
                self.done.set()

        def decode(*a, **kw):
            self.calls += 1
            if self.calls == self.at:
                self.thread = threading.current_thread()
            elif self.calls > self.at and not self.release.is_set():
                self.release.set()
                assert self.done.wait(60.0)
            return outer(*a, **kw)

        monkeypatch.setattr(owner, name, stalled_inner)
        eng.backend.decode = decode


@pytest.mark.parametrize("point", ["chunk", "run"])
@pytest.mark.parametrize("mode", list(MODES))
def test_a_dispatch_stalled_inside_the_decode_wakes_apart_from_the_next_epoch(
        tiny, monkeypatch, mode, point):
    """The stall passed ``_check_live``: on waking, the abandoned decode
    builds its chunk or runs it over the abandoned storage while the next
    epoch is live. That epoch's streams equal a fresh engine's, and none of
    its dispatches meets the abandoned chunk ("KV storage moved")."""
    stall_s = 0.3
    eng = make_engine(tiny, epoch_stall_s=stall_s, **MODES[mode])
    fresh = make_engine(tiny, **MODES[mode])
    stall = None
    try:
        _wave(eng)  # every op's first-call grace is spent
        stall = StallingInside(eng, monkeypatch, point)
        streams, reasons = _wave(eng, prompts=STALLED)
        assert stall.stalled.is_set() and reasons == ["error"] * 3
        assert eng.stats["epoch_stalls"] == 1 and eng.stats["stream_errors"] == 3
        streams, reasons = _wave(eng)
        assert stall.done.is_set() and stall.late_error is None  # it ran to its end
        want_streams, want_reasons = _wave(fresh)
        assert streams == want_streams and reasons == want_reasons == ["length"] * 3
        assert eng.stats["epoch_stalls"] == 1 and eng.stats["stream_errors"] == 3
        deadline = time.monotonic() + 5.0
        while eng._guard.resolved == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng._guard.resolved == 1  # its late result was discarded
        # The next epoch's chunks capture apart from the shared scope, where
        # the abandoned decode's chunks capture.
        from cake_tpu_torch.models.llama.fused import SHARED_SCOPE

        live = eng.backend._chunks
        assert live and live.scope is not None and live.scope is not SHARED_SCOPE
        assert all(c.scope is live.scope for c in live.values())
        if mode != "dense":
            assert pool_whole(eng)
    finally:
        if stall is not None:
            stall.release.set()
        eng.stop()
        fresh.stop()


@pytest.mark.parametrize("mode", ["dense", "prefix"])
def test_a_stopped_engine_is_freed_without_the_garbage_collector(tiny, mode):
    """With every gate armed, nothing in the engine refers back to it (the
    guard, the fair queue's cost, a stream's close hook): a stopped engine
    and its KV storage go when the last reference does, as before admission
    existed. Callers that serve one engine after another rely on it."""
    import gc
    import weakref

    eng = make_engine(tiny, epoch_stall_s=5.0, tenant_rate=1e6, tenant_streams=8,
                      shed_queue_depth=64, default_deadline_s=60.0, slo_ttft_ms=100.0,
                      stream_buffer_tokens=1024, **MODES[mode])
    _wave(eng)
    eng.stop()
    refs = [weakref.ref(eng), weakref.ref(eng.backend), weakref.ref(eng._queue)]
    gc.disable()
    try:
        del eng
        assert [r() is None for r in refs] == [True] * 3
    finally:
        gc.enable()


def test_guard_off_dispatches_inline_and_on_runs_on_the_guard(tiny):
    threads = {}
    for stall_s in (0.0, 5.0):
        eng = make_engine(tiny, epoch_stall_s=stall_s)
        real = eng.backend.decode

        def decode(*a, _real=real, _key=stall_s, **kw):
            threads[_key] = threading.current_thread().name
            return _real(*a, **kw)

        eng.backend.decode = decode
        try:
            collect(eng.submit([Message.user("where do I run")], 6, GREEDY))
        finally:
            eng.stop()
        assert (eng._guard is None) == (stall_s == 0.0)
    assert threads == {0.0: "batch-engine", 5.0: "stall-guard"}


# --------------------------------------------------------------------- TCP


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    import _tcp_cluster as C
    from cake_tpu_torch.runtime.master import DistributedForwardStep

    model_dir = C.write_checkpoint(tmp_path_factory.mktemp("tcp_admission") / "model", seed=31)
    cfg = LlamaConfig.from_model_dir(model_dir)
    with C.port_cluster(model_dir, max_seq_len=MAX_SEQ) as (topo, _):
        step = DistributedForwardStep(cfg, model_dir, topo, dtype=torch.float32,
                                      max_seq_len=MAX_SEQ, device="cpu")
        yield cfg, step
        step.close()


def test_watchdog_and_deadlines_over_tcp(cluster):
    from cake_tpu_torch.runtime.batch_backend import DistributedBatchBackend

    cfg, step = cluster

    def engine(**kw):
        eng = BatchEngine(cfg, None, ByteTokenizer(), max_seq_len=MAX_SEQ,
                          cache_dtype=torch.float32,
                          serve=ServeConfig(max_batch=4, decode_chunk_size=4, **kw),
                          backend=DistributedBatchBackend(step))
        eng.start()
        return eng

    fresh = engine()
    try:
        want = _wave(fresh)
    finally:
        fresh.stop()
    eng = engine(epoch_stall_s=0.5)
    stall = None
    try:
        assert _wave(eng) == want
        stall = StallingDecode(eng, at=1)
        with eng._cv:
            hs = [eng.submit([Message.user(p)], 12, GREEDY) for p in STALLED]
        assert [len(collect(h)) for h in hs] == [1] * 3
        assert [h.finish_reason for h in hs] == ["error"] * 3
        assert eng.wait_idle(10.0)
        assert _wave(eng) == want and stall.late_error is not None
        # A deadline over TCP: the stream ends at a chunk boundary.
        slow_decode(eng, 0.1)
        h = eng.submit([Message.user(WAVE[0])], 24, GREEDY, deadline_s=0.3)
        got = collect(h)
        assert h.finish_reason == "deadline" and got == want[0][0][: len(got)]
    finally:
        if stall is not None:
            stall.release.set()
        eng.stop()


# --------------------------------------------------------------------- API


def _post(port, route, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", route, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read().decode()
    finally:
        conn.close()


@pytest.fixture
def api(tiny):
    config, params = tiny
    step = LocalForwardStep(config, params, max_seq_len=MAX_SEQ, cache_dtype=torch.float32,
                            device="cpu")
    gen = LlamaGenerator(config, step, ByteTokenizer(), GREEDY)
    servers = []

    def serve(**serve_kw):
        eng = make_engine(tiny, start=False, **serve_kw)
        srv_api = ApiServer(gen, default_max_tokens=4, engine=eng)
        srv = srv_api.make_server("127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        servers.append((srv, srv_api, thread))
        return srv.server_port, eng

    yield serve
    for srv, srv_api, thread in servers:
        srv.shutdown()
        srv.server_close()
        srv_api.close()
        thread.join(10)


CHAT = "/api/v1/chat/completions"


def test_api_refuses_bad_admission_fields_with_400(api):
    port, _ = api()
    msgs = [{"role": "user", "content": "hi"}]
    for body, headers in (({"tenant": ""}, None), ({"tenant": 7}, None),
                          ({"tenant": "t" * 65}, None), ({}, {"X-Cake-Tenant": "h" * 65}),
                          ({"deadline_s": 0}, None), ({"deadline_s": -2}, None),
                          ({"deadline_s": "soon"}, None), ({"priority": 3}, None)):
        status, _, text = _post(port, CHAT, {"messages": msgs, "stream": True, **body}, headers)
        assert status == 400, (body, text)
        assert "text/event-stream" not in text


def test_api_maps_quota_to_429_and_shed_to_503(api):
    port, eng = api(tenant_rate=1.0, tenant_burst=30.0, retry_after_s=1.0)
    msgs = [{"role": "user", "content": "hi"}]
    status, _, _ = _post(port, CHAT, {"messages": msgs, "max_tokens": 4}, {"X-Cake-Tenant": "a"})
    assert status == 200
    status, headers, text = _post(port, CHAT, {"messages": msgs, "max_tokens": 4},
                                  {"X-Cake-Tenant": "a"})
    assert status == 429 and int(headers["Retry-After"]) >= 1 and "token rate" in text
    # The body's tenant wins over the header: tenant b has its own bucket.
    status, _, _ = _post(port, CHAT, {"messages": msgs, "max_tokens": 4, "tenant": "b"},
                         {"X-Cake-Tenant": "a"})
    assert status == 200
    eng._wait_est.observe(10.0)
    status, headers, text = _post(port, CHAT, {"messages": msgs, "max_tokens": 4,
                                               "tenant": "c", "deadline_s": 0.5,
                                               "priority": 0})
    assert status == 503 and headers["Retry-After"] == "2" and "deadline" in text
    stats = json.loads(urllib_get(port, "/stats"))
    assert stats["tenants"]["a"]["quota_refusals"] == 1
    assert stats["engine"]["shed"] == 1 and stats["engine"]["quota_refusals"] == 1
    assert stats["tenants"]["c"]["active_streams"] == 0  # the shed refunded its charge


def urllib_get(port, route) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", route)
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def test_api_cancel_route(api):
    port, eng = api()
    slow_decode(eng, 0.05)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", CHAT, json.dumps({"messages": [{"role": "user", "content": "long"}],
                                           "max_tokens": 100, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    first = resp.readline().decode()
    while not first.startswith("data: "):
        first = resp.readline().decode()
    rid = json.loads(first[6:])["id"]
    status, _, text = _post(port, "/api/v1/cancel", {"id": rid})
    assert status == 200 and json.loads(text) == {"id": rid, "cancelled": True}
    rest = resp.read().decode()
    conn.close()
    finishes = [json.loads(line[6:])["choices"][0]["finish_reason"]
                for line in rest.splitlines()
                if line.startswith("data: {") and json.loads(line[6:])["choices"]]
    assert finishes[-1] == "cancelled"
    assert eng.wait_idle(10.0) and eng.stats["cancelled"] == 1
    status, _, text = _post(port, "/api/v1/cancel", {"id": rid})
    assert status == 200 and json.loads(text)["cancelled"] is False
    status, _, _ = _post(port, "/api/v1/cancel", {})
    assert status == 400
