"""The port's continuous scheduler against the JAX package's on the CPU:
preemption under page pressure.

Both packages' engines over one tiny checkpoint (tests/_continuous_pair.py),
every request submitted before ``start()`` so both admit the same group. The
token ids are equal, and so are the finish reasons and the preemption,
restore, truncation, segment and join counts:

  * the pressured pair at a pool of 14 pages, plain and with the prefix
    cache, greedy and seeded sampled (the spills come back inside their
    segment);
  * a spill whose remaining budget no longer fits its segment, which seeds
    a second one (max_seq 512, 15 pages).
"""

import pytest

import _continuous_pair as P
from _continuous_pair import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    return P.packages(P.write_checkpoint(tmp_path_factory.mktemp("tiny_preempt_jax")))


@pytest.mark.parametrize("knobs", list(P.KNOBS))
@pytest.mark.parametrize("mode", ["paged", "prefix"])
def test_preempted_streams_and_counts_equal_the_jax_engine(packages, mode, knobs):
    reqs = [(p, 48, None) for p in P.PRESSURE]
    got = P.both(packages, lambda pkg, e: P.pressure(pkg, e, P.KNOBS[knobs], reqs),
                 scheduler="continuous", max_pages=P.SMALL_POOL, **P.MODES[mode])
    assert got["port"] == got["jax"]
    out, finish, stats = got["port"]
    assert stats["preemptions"] >= 1 and stats["restores"] >= 1
    assert stats["page_truncations"] == 0 and stats["batches"] == 1
    assert [len(ids) for ids in out] == [48, 48] and finish == ["length", "length"]


def test_spill_seeded_segment_equals_the_jax_engine(packages):
    reqs = [(P.PRESSURE[0], 140, 2), (P.PRESSURE[1], 48, 0)]
    got = P.both(packages, lambda pkg, e: P.pressure(pkg, e, P.KNOBS["greedy"], reqs),
                 max_seq=512, scheduler="continuous", max_pages=15, **P.MODES["paged"])
    assert got["port"] == got["jax"]
    stats = got["port"][2]
    assert stats["batches"] >= 2 and stats["restores"] >= 1 and stats["page_truncations"] == 0
