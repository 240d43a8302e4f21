"""The port's continuous scheduler against the JAX package's on the CPU,
with the prefix cache: the mixed wave with joins, and the epoch scheduler's
truncation under a pool too small for its pair of long streams.

Both packages' engines over one tiny checkpoint (tests/_continuous_pair.py),
the requests that open a segment submitted before ``start()`` so both admit
the same group: the token ids, finish reasons and counts are equal.
"""

import pytest

import _continuous_pair as P
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    return P.packages(P.write_checkpoint(tmp_path_factory.mktemp("tiny_continuous_prefix_jax")))


@pytest.mark.parametrize("knobs", list(P.KNOBS))
def test_continuous_prefix_streams_equal_the_jax_engine(packages, knobs):
    got = P.both(packages, lambda pkg, e: P.mixed(pkg, e, P.KNOBS[knobs]),
                 scheduler="continuous", **P.MODES["prefix"])
    assert got["port"] == got["jax"]
    assert all(len(ids) > 1 for ids in got["port"][0]) and got["port"][1] >= 1


@pytest.mark.parametrize("mode", ["paged", "prefix"])
def test_epoch_truncation_equals_the_jax_engine(packages, mode):
    """The epoch scheduler keeps truncating under page pressure, as the
    reference's does: the same streams end at the same token."""
    reqs = [(p, 48, None) for p in P.PRESSURE]
    got = P.both(packages, lambda pkg, e: P.pressure(pkg, e, P.KNOBS["greedy"], reqs),
                 scheduler="epoch", max_pages=P.SMALL_POOL, **P.MODES[mode])
    assert got["port"] == got["jax"]
    assert got["port"][2]["page_truncations"] >= 1
    assert min(len(ids) for ids in got["port"][0]) < 48
