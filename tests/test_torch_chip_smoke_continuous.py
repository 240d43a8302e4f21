"""``chip_smoke.py``'s phase ``engine_continuous`` rehearsed on the CPU.

On the card the phase drives the continuous scheduler at Llama-3-8B width
(pages of 128, 384 tokens out). Here it runs over a tiny 2-layer model with
CPU tensors, cut to 96 tokens out over pages of 16 so that the pool of one
epoch's admission charges runs dry within them: every gate of the phase
runs (same admission ≡ epoch, preemptions and restores on the small pool
and none on the full one, the pool whole, the launch counts of the plain
versions, the restore checks, no new decode chunk key on a second run, a
restore into a running segment), and here both restore routes are taken.
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

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_engine_continuous_rehearses_on_the_cpu(smoke, monkeypatch, capsys):
    config = LlamaConfig.tiny(num_hidden_layers=2)
    params = fuse_params(M.init_params(config, torch.Generator().manual_seed(0), torch.bfloat16,
                                       "cpu"))
    step = LocalForwardStep(config, params, max_seq_len=smoke.MAX_SEQ,
                            cache_dtype=torch.bfloat16, device="cpu")
    gen = LlamaGenerator(config, step, ByteTokenizer(),
                         SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    monkeypatch.setattr(smoke, "ENGINE_PAGE", 16)
    cont = smoke.phase_engine_continuous(torch, {"generator": gen, "card": "cpu"}, tokens=96)
    assert [smoke.json.loads(line)["phase"] for line in capsys.readouterr().out.splitlines()] == [
        "engine_continuous"]
    # 8 prompts of 472 tokens: 30 pages of 16 and the reserve each.
    assert cont["config"]["page_size"] == 16 and cont["config"]["small_pool"] == 8 * 31
    assert cont["same_admission_equal_streams"] == smoke.ENGINE_BATCH
    assert cont["ragged_equal_streams"] == len(smoke.RAGGED_TURNS)  # plain arithmetic here
    assert cont["ragged"]["continuous"]["joins"] > 0 and cont["ragged"]["epoch"]["joins"] > 0
    small, full = cont["pressure"][2], cont["pressure"][3]
    assert small["wave"]["preemptions"] >= 2 and full["wave"]["preemptions"] == 0
    assert small["repeat_new_chunk_keys"] == 0 and small["repeat_equal_streams"] == 8
    for r in cont["pressure"]:
        assert r["launches"] == r["expected_launches"] and r["pool_whole"]
        assert r["launches"]["paged_chunk_attention_plain"] > 0
    assert small["launches"]["threefry_noise_plain"] > 0
    assert cont["pressure"][4]["in_segment_restores"] >= 1
    assert cont["restore_routes"]["in_segment"] > 0 and cont["restore_routes"]["seeded"] > 0
    assert cont["restore_state_equal"] == cont["restore_checks"] == len(cont["restore_check_rows"])
    assert 0 < cont["restore_checks"] and cont["restore_kv_rel_err"] <= smoke.TOL
    assert cont["pressure_agreement"]["greedy"]["equal"] == smoke.ENGINE_BATCH
    assert cont["pressure_agreement"]["sampled"]["equal"] == smoke.ENGINE_BATCH
    assert cont["launches"] == {"paged_decode_attention": 0, "paged_chunk_attention": 0,
                                "threefry_noise": 0}  # the kernels never ran here
