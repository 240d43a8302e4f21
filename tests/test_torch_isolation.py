"""The port stands alone: ``cake_tpu_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package (they keep their own copies of
the host-side modules they need), nor PyYAML, which the card's machine
lacks (the topology reader is the port's own)."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "cake_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+yaml\b|from\s+yaml\b)|\bcake_tpu\.(?!_torch)|\bcake_tpu\b(?!_torch)\s+import|import\s+cake_tpu\b(?!_torch)", re.M)


def test_port_files_exist():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package_in_source(path):
    hits = [m.group(0) for m in FORBIDDEN.finditer(path.read_text())]
    assert hits == [], f"{path.relative_to(REPO)} mentions {hits}"


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import cake_tpu_torch, cake_tpu_torch.cli, cake_tpu_torch.runtime.api\n"
        "import cake_tpu_torch.models.llama.generator, cake_tpu_torch.io.safetensors_io\n"
        "import cake_tpu_torch.runtime.serving, cake_tpu_torch.runtime.batch_backend\n"
        "import cake_tpu_torch.models.llama.batch, cake_tpu_torch.runtime.prefix_cache\n"
        "import cake_tpu_torch.runtime.admission, cake_tpu_torch.obs.slo\n"
        "import cake_tpu_torch.models.llama.fused, cake_tpu_torch.ops.fused_norm_matmul\n"
        "import cake_tpu_torch.ops.fused_ingest, cake_tpu_torch.ops.fused_sample_tail\n"
        "import cake_tpu_torch.runtime.proto, cake_tpu_torch.runtime.client\n"
        "import cake_tpu_torch.runtime.worker, cake_tpu_torch.runtime.master\n"
        "import cake_tpu_torch.runtime.router, cake_tpu_torch.parallel.topology\n"
        "import cake_tpu_torch.ops.moe\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'cake_tpu' or m.startswith('cake_tpu.') or m == 'yaml')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_pattern_catches_what_it_should():
    for bad in ("import jax\n", "from jax import numpy\n", "from cake_tpu.ops import x\n",
                "import yaml\n", "    from yaml import safe_load\n",
                "import cake_tpu\n", "x = cake_tpu.models\n"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import cake_tpu_torch\n", "from cake_tpu_torch.ops import x\n",
               "# see cake_tpu/ops/norm.py\n"):
        assert not FORBIDDEN.search(ok), ok
