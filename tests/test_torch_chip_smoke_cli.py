"""``chip_smoke.py``'s phase ``cli`` rehearsed on the CPU: the port's CLI
answers a prompt and serves the ``--api-batch`` engine (``--device cpu``)."""

import pytest
import torch

import _chip_smoke_rehearsal as R
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def smoke():
    return R.load_smoke()


def test_cli_rehearses_on_the_cpu(smoke, capsys):
    smoke.phase_cli(torch, ("--device", "cpu"))
    assert R.phases(capsys.readouterr().out) == ["cli"]
