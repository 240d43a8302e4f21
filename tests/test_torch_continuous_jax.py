"""The port's continuous scheduler against the JAX package's on the CPU:
the mixed wave with joins, dense and paged.

The scenario of tests/test_torch_continuous.py (tests/_continuous_pair.py),
served by the JAX ``BatchEngine`` and by the port's, both with
``scheduler="continuous"``, greedy and seeded sampled: the token ids are
equal. The two requests that open the segment are submitted before
``start()``, so both engines admit the same group; the other two join.
tests/test_torch_continuous_prefix_jax.py holds the prefix-cache mode and
tests/test_torch_preempt_jax.py the preemption scenarios.
"""

import pytest

import _continuous_pair as P
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    return P.packages(P.write_checkpoint(tmp_path_factory.mktemp("tiny_continuous_jax")))


@pytest.mark.parametrize("knobs", list(P.KNOBS))
@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_continuous_streams_equal_the_jax_engine(packages, mode, knobs):
    got = P.both(packages, lambda pkg, e: P.mixed(pkg, e, P.KNOBS[knobs]),
                 scheduler="continuous", **P.MODES[mode])
    assert got["port"] == got["jax"]
    assert all(len(ids) > 1 for ids in got["port"][0]) and got["port"][1] >= 1
