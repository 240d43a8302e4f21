"""The port's topology (``cake_tpu_torch/parallel/topology.py``) against the
JAX package's: the port's own reader equals ``yaml.safe_load`` plus the JAX
``Topology`` on schema texts (ranges, singles, replicas, comments, quoting,
flow lists); ``stage_plan``, ``replica_groups``, ``owner_map`` and
``validate`` (its errors too) agree; the writer's output reads back equal
through both readers; and what lies outside the schema is refused."""

import pytest
import yaml

from cake_tpu.parallel.topology import Topology as JaxTopology
from cake_tpu_torch.parallel import topology as T

TEXTS = {
    "readme": """\
# Cake's README deployment: two workers, the master runs nothing.
w1:
  host: 192.168.1.2:10128
  description: first half
  layers:
    - model.layers.0-15
w2:
  host: "192.168.1.3:10128"   # quoted host
  description: 'second half'
  layers:
    - "model.layers.16-31"
""",
    "master_middle": """\
w1:
  host: 127.0.0.1:1
  layers: [model.layers.0-1]
w2:
  host: 127.0.0.1:2
  layers: ['model.layers.4-5', "model.layers.7"]
""",
    "replicas": """\
w2:
    host: h:1
    layers:
    - model.layers.16-31
w2b:   # the standby
    host: h:2
    description: "it's the replica # not a comment"
    layers:
    - model.layers.16-31
w1:
    host: h:3
    description: 'a ''quoted'' word'
    layers:
      - model.layers.0-15
""",
    "singles": """\
"node one":
  host: 10.0.0.1:5
  layers:
    - model.layers.3
    - model.layers.5
    - model.layers.7-9  # a range after singles

empty:
  host: 10.0.0.2:5
  layers: []
""",
    "empty": "# nothing here\n",
}
N_LAYERS = {"readme": 32, "master_middle": 8, "replicas": 32, "singles": 12, "empty": 4}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_reader_equals_yaml_and_the_jax_topology(name, tmp_path):
    text, n = TEXTS[name], N_LAYERS[name]
    assert T.parse_topology(text) == (yaml.safe_load(text) or {})
    path = tmp_path / "topology.yml"
    path.write_text(text)
    ours, theirs = T.Topology.from_path(path), JaxTopology.from_path(path)
    assert ours.to_dict() == theirs.to_dict()
    assert [(s.node, s.lo, s.hi) for s in ours.stage_plan(n)] == [
        (s.node, s.lo, s.hi) for s in theirs.stage_plan(n)]
    assert ours.replica_groups() == theirs.replica_groups()
    assert ours.owner_map(n) == theirs.owner_map(n)
    ours.validate(n)
    theirs.validate(n)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_writer_reads_back_equal(name, tmp_path):
    topo = T.Topology.from_dict(T.parse_topology(TEXTS[name]))
    path = tmp_path / "out.yml"
    topo.save(path)
    text = path.read_text()
    assert T.parse_topology(text) == topo.to_dict() == (yaml.safe_load(text) or {})
    assert T.Topology.from_path(path).to_dict() == JaxTopology.from_path(path).to_dict()


@pytest.mark.parametrize("layers, n", [
    ({"a": ["model.layers.0-3"], "b": ["model.layers.2-5"]}, 8),  # partial overlap
    ({"a": ["model.layers.0-9"]}, 8),                              # out of range
    ({"a": ["model.layers.0-3", "model.layers.2"]}, 8),            # declared twice
    ({"a": ["model.layers.3-3"]}, 8),                              # end <= start
    ({"a": ["layers.1"]}, 8),                                      # malformed
])
def test_validate_errors_equal_the_jax_package(layers, n):
    spec = {k: {"host": "h:1", "layers": v} for k, v in layers.items()}
    with pytest.raises(ValueError) as ours:
        T.Topology.from_dict(spec).validate(n)
    with pytest.raises(ValueError) as theirs:
        JaxTopology.from_dict(spec).validate(n)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("text", [
    "w1: host\n",                                        # a node that is no mapping
    "w1:\n  port: 1\n",                                  # a key outside the schema
    "w1:\n  host: 10128\n",                              # YAML would read an int
    "w1:\n  host: a\n  layers: model.layers.1\n",        # layers not a list
    "  host: a\n",                                       # indented outside a node
    "w1:\n  host: a\n   description: b\n",               # inconsistent indentation
    "w1:\n  host: [a]\n",                                # a flow list as a scalar
    "w1:\n  layers: []\n",                               # no host
    "w1:\n  host: a\nw1:\n  host: b\n",                  # a node twice
    "w1:\n  host: 'a\n",                                 # an unterminated quote
    "---\nw1:\n  host: a\n",                             # a document marker
    "w1:\n\thost: a\n",                                  # a tab
])
def test_outside_the_schema_is_refused(text):
    with pytest.raises(ValueError, match="topology"):
        T.parse_topology(text)


def test_the_module_does_not_import_yaml():
    source = open(T.__file__).read()
    assert "import yaml" not in source and "from yaml" not in source
