"""``chip_smoke.py``'s phase ``engine_admission`` rehearsed on the CPU.

On the card the phase drives admission on the paged engine at Llama-3-8B
width (pages of 128, 32 tokens out). Here it runs over a tiny 2-layer model
with CPU tensors, pages of 16 and 8 tokens out, and every gate of the phase
runs: equal streams with every gate armed and off, the launch counts of the
plain versions, fair queueing against FIFO, the quotas, the shed gates, the
three deadline cases, the API's 429, 503 and cancel, and the stall watchdog
with the stalled thread's garbage written while the next wave runs, and a
stall inside the real decode that wakes while the next wave runs.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)
from cake_tpu_torch.models.llama import model as M
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import LlamaGenerator, LocalForwardStep, SamplingConfig
from cake_tpu_torch.models.llama.tokenizer import ByteTokenizer
from cake_tpu_torch.ops.fuse import fuse_params
from cake_tpu_torch.runtime.admission import StallGuard

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_engine_admission_rehearses_on_the_cpu(smoke, monkeypatch, capsys):
    config = LlamaConfig.tiny(num_hidden_layers=2)
    params = fuse_params(M.init_params(config, torch.Generator().manual_seed(0), torch.bfloat16,
                                       "cpu"))
    step = LocalForwardStep(config, params, max_seq_len=smoke.MAX_SEQ,
                            cache_dtype=torch.bfloat16, device="cpu")
    gen = LlamaGenerator(config, step, ByteTokenizer(),
                         SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    monkeypatch.setattr(smoke, "ENGINE_PAGE", 16)
    # The stall inside the dispatch hits a new decode key, which waits out
    # the first call's grace: 3x here (CPU dispatches build and capture
    # nothing), 10x on the card.
    monkeypatch.setattr(StallGuard, "FIRST_CALL_GRACE", 3.0)
    row = smoke.phase_engine_admission(torch, {"generator": gen, "card": "cpu"}, tokens=8)
    assert [smoke.json.loads(line)["phase"] for line in capsys.readouterr().out.splitlines()] == [
        "engine_admission"]
    assert row["equal_streams"] == smoke.ENGINE_BATCH
    assert row["watchdog"]["equal_streams_after"] == smoke.ENGINE_BATCH
    assert row["watchdog"]["finish_reasons"] == ["error"] * smoke.ENGINE_BATCH
    assert row["watchdog"]["epoch_stalls"] == 1 and row["watchdog"]["old_storage_nan"]
    inside = row["watchdog_inside"]
    assert inside["finish_reasons"] == ["error"] * smoke.ENGINE_BATCH
    assert inside["equal_streams_after"] == smoke.ENGINE_BATCH
    assert inside["stream_errors"] == [smoke.ENGINE_BATCH, 0] and inside["epoch_stalls"] == 2
    assert inside["late_error"] == "None" and inside["guard_resolved_late"] == 2
    assert row["fairness"]["fair"]["b_rounds"] == [0]
    assert min(row["fairness"]["fifo"]["b_positions"]) >= smoke.ADMISSION_FLOOD
    assert row["deadlines"]["spilled"]["spilled_with_deadline"]
    assert not row["deadlines"]["spilled"]["restored"]
    assert row["api"]["429"]["status"] == 429 and row["api"]["503"]["retry_after"] == "2"
    assert row["counts"]["shed"] >= 3 and row["counts"]["quota_refusals"] >= 3
    assert row["launch_gate"] and set(row["launches"]) == {"paged_decode_attention",
                                                           "paged_chunk_attention"}
    assert row["launches"] == {"paged_decode_attention": 0, "paged_chunk_attention": 0}
