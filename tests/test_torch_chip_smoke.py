"""``chip_smoke.py`` rehearsed on the CPU at a tiny size.

On the card the script drives the port at Llama-3-8B width. Here its phases
run at a tiny config with CPU tensors, so every attention call takes the
plain version: this checks the control flow, the launch-count bookkeeping,
the API and CLI drives and the shape of the kernels line. Without CUDA, or
outside a checkout of the repo, the script must fail and print no result.
"""

import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig

REPO = Path(__file__).resolve().parent.parent
KERNEL_KEYS = {
    "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
    "bound_ms", "bound_by", "library_ms",
}


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phases_rehearse_on_the_cpu(smoke, capsys):
    config = LlamaConfig.tiny(num_hidden_layers=2)
    row = smoke.phase_generate(torch, "cpu", dev=torch.device("cpu"), config=config)
    assert row["launches"] == row["expected_launches"]
    assert row["launches"]["decode_attention_plain"] == 2 * (smoke.DECODE_TOKENS - 1)
    assert row["launches"]["flash_attention_plain"] == 2
    assert row["prompt_tokens"] == smoke.PROMPT_TOKENS
    assert row["check"]["max_abs_err"] == 0.0  # on the CPU both runs are the plain path
    smoke.phase_api(row)
    smoke.phase_cli(torch, ("--device", "cpu"))
    timed = {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5,
             "bound_by": "bytes", "library_ms": None}
    rows = {("decode_attention", "main_path"): timed, ("chunk_prefill_attention", "main_path"): timed}
    summary = smoke.kernel_summary(rows, row)
    assert [k["name"] for k in summary["kernels"]] == ["decode_attention", "chunk_prefill_attention"]
    assert all(set(k) == KERNEL_KEYS for k in summary["kernels"])
    phases = [json.loads(line)["phase"] for line in capsys.readouterr().out.splitlines()]
    assert phases == ["generate", "full_model_check", "api", "cli"]


def test_bound_takes_the_larger_of_bytes_and_operations(smoke):
    assert smoke.bound(3.35e9, 1.0) == (1.0, "bytes")
    assert smoke.bound(1.0, 989e9) == (1.0, "operations")


@pytest.mark.parametrize(
    "name,family",
    [
        ("void cake::decode_kernel<__nv_bfloat16, 128, 4>(...)", "decode_attention"),
        ("void cake::chunk_kernel<__nv_bfloat16, 128>(...)", "chunk_prefill_attention"),
        ("nvjet_tst_128x64_64x8_1x2_h_bz_TNN", "matmul"),
        ("void gemv2T_kernel_val<int, int, __nv_bfloat16>(...)", "matmul"),
        ("void at::native::vectorized_elementwise_kernel<4, ...>(...)", "other"),
    ],
)
def test_profile_kernel_families(smoke, name, family):
    assert smoke._kernel_family(name) == family


def _run(script: Path, cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120
    )


def test_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = _run(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
