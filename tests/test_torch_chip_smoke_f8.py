"""``chip_smoke.py``'s phases ``generate_f8`` and ``engine_f8`` rehearsed on
the CPU at a tiny size, over the generate phase's row: the plain versions
take every call and no launch counts as over f8 (the side counts are the
kernels'); the f8 pool holds half the bf16 pool's bytes (the bf16 engine's
pool, as phase engine reports it, measured here on an engine of the same
configuration)."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


@pytest.fixture(scope="module")
def main_path(smoke):
    return R.generate_row(smoke)


def _bf16_pool_bytes(smoke, main_path) -> int:
    """phase engine's ``pool_bytes``: its paged engine's pool, K and V."""
    from cake_tpu_torch.runtime.serving import BatchEngine, ServeConfig

    gen = main_path["generator"]
    serve = ServeConfig(max_batch=smoke.ENGINE_BATCH, decode_chunk_size=8, kv_mode="paged",
                        page_size=smoke.ENGINE_PAGE, prefix_cache=True)
    engine = BatchEngine(gen.config, gen.step.params, gen.tokenizer,
                         max_seq_len=smoke.ENGINE_MAX_SEQ, cache_dtype=torch.bfloat16,
                         serve=serve, device=gen.step.device)
    engine.backend.init_kv(smoke.ENGINE_BATCH)
    pool = engine.backend._pool
    return 2 * pool.k.numel() * pool.k.element_size()


def test_f8_phases_rehearse_on_the_cpu(smoke, main_path, capsys):
    f8_gen = smoke.phase_generate_f8(torch, main_path)
    for r in f8_gen["runs"]:
        assert r["launches"] == r["expected_launches"]
        assert r["launches"]["decode_attention_plain"] > 0 and r["launches"]["decode_attention.f8"] == 0
    assert f8_gen["chunked_equal_tokens"] == smoke.DECODE_TOKENS
    assert set(f8_gen["graph_bits"]) == set(smoke.GRAPH_KNOBS)
    assert f8_gen["kv_bytes"] * 2 == f8_gen["bf16_kv_bytes"]
    assert f8_gen["check"]["max_abs_err"] == 0.0
    engine = {"pool_bytes": _bf16_pool_bytes(smoke, main_path)}
    f8_engine = smoke.phase_engine_f8(torch, main_path, engine)
    assert [(r["spec"], r["kv_mode"]) for r in f8_engine["runs"]] == [
        ("none", "paged"), ("none", "dense"), ("all", "paged"), ("all", "dense")]
    for r in f8_engine["runs"]:
        assert r["launches"] == r["expected_launches"]
    assert f8_engine["runs"][0]["warm_prefix_hits"] > 0
    assert f8_engine["dense_equal_paged"] == f8_engine["warm_equal_cold"] == {
        "none": smoke.ENGINE_BATCH, "all": smoke.ENGINE_BATCH}
    assert 2 * f8_engine["pool_bytes"] == f8_engine["bf16_pool_bytes"]
    # The kernels line reads both rows' launches over f8.
    assert "f8_launches" in f8_gen and "f8_launches" in f8_engine
    assert R.phases(capsys.readouterr().out) == [
        "generate_f8", "f8_model_check", "engine_f8", "paged_none_f8_model_check",
        "dense_none_f8_model_check", "paged_all_f8_model_check", "dense_all_f8_model_check"]
