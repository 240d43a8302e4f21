"""``chip_smoke.py``'s phases ``generate`` and ``api`` rehearsed on the CPU
at a tiny size (2 layers): every attention call takes its plain version,
so this checks the generator's launch-count bookkeeping, the full-model
check and the serialized API's drive."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


def test_generate_and_api_rehearse_on_the_cpu(smoke, capsys):
    row = R.generate_row(smoke)
    assert row["launches"]["decode_attention_plain"] == 2 * (smoke.DECODE_TOKENS - 1)
    assert row["launches"]["flash_attention_plain"] == 2
    assert row["prompt_tokens"] == smoke.PROMPT_TOKENS
    assert row["check"]["max_abs_err"] == 0.0  # on the CPU both runs are the plain path
    smoke.phase_api(row)
    assert R.phases(capsys.readouterr().out) == ["generate", "full_model_check", "api"]
