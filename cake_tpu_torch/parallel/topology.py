"""Cluster topology: the YAML schema, the layer-range DSL, stage planning
(port of ``cake_tpu/parallel/topology.py``).

    worker_name:
      host: "1.2.3.4:10128"
      description: "optional text"
      layers:
        - "model.layers.0-15"      # a..b inclusive
        - "model.layers.20"        # one layer

The stage plan is the ordered contiguous block ranges and their owners: one
network hop per run of layers a node owns. Layers no node names run on the
master (``MASTER_NODE``). Nodes that declare the IDENTICAL layer set form a
replica group (``replica_groups``), routed by runtime/router.py; the stage
plan names only the group's first-declared node.

The port reads and writes topology files without PyYAML (``parse_topology``
and ``format_topology``): only this schema, a mapping of node names to
``host``, ``description`` and a ``layers`` list, with plain, single- or
double-quoted scalars, block or flow lists and comments. Anything else is
refused with an error naming the line.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

LAYER_PREFIX = "model.layers."
_RANGE_RE = re.compile(r"^model\.layers\.(\d+)-(\d+)$")
_SINGLE_RE = re.compile(r"^model\.layers\.(\d+)$")

MASTER_NODE = "__master__"  # synthetic owner for layers not in the topology


@dataclasses.dataclass
class Node:
    """One worker entry."""

    name: str
    host: str
    description: str = ""
    layers: list[str] = dataclasses.field(default_factory=list)
    _indices_cache: list[int] | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def layer_indices(self) -> list[int]:
        """The range DSL expanded: ``model.layers.a-b`` covers a..b
        INCLUSIVE and needs b > a; a single entry names one layer. Parsed
        once (``layers`` is treated as immutable after construction)."""
        if self._indices_cache is not None:
            return self._indices_cache
        out: list[int] = []
        for spec in self.layers:
            m = _RANGE_RE.match(spec)
            if m:
                start, end = int(m.group(1)), int(m.group(2))
                if end <= start:
                    raise ValueError(f"{self.name}: range '{spec}' must have end > start")
                out.extend(range(start, end + 1))
                continue
            m = _SINGLE_RE.match(spec)
            if m:
                out.append(int(m.group(1)))
                continue
            raise ValueError(f"{self.name}: malformed layer spec '{spec}'")
        object.__setattr__(self, "_indices_cache", out)
        return out

    def is_layer_owner(self, layer_name: str) -> bool:
        """Prefix ownership: ``model.layers.3.self_attn...`` belongs to the
        owner of layer 3."""
        if not layer_name.startswith(LAYER_PREFIX):
            return False
        idx_str = layer_name[len(LAYER_PREFIX) :].split(".", 1)[0]
        if not idx_str.isdigit():
            return False
        return int(idx_str) in set(self.layer_indices())


@dataclasses.dataclass(frozen=True)
class Stage:
    """A contiguous block range [lo, hi) owned by one node."""

    node: str
    lo: int
    hi: int

    @property
    def n_layers(self) -> int:
        return self.hi - self.lo


class Topology:
    """Worker-name -> Node map with stage planning."""

    def __init__(self, nodes: dict[str, Node]):
        self.nodes = nodes

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        nodes = {}
        for name, spec in (d or {}).items():
            nodes[name] = Node(
                name=name,
                host=spec["host"],
                description=spec.get("description", ""),
                layers=list(spec.get("layers", [])),
            )
        return cls(nodes)

    @classmethod
    def from_path(cls, path: str | Path) -> "Topology":
        with open(path) as f:
            return cls.from_dict(parse_topology(f.read()))

    def to_dict(self) -> dict:
        return {
            name: {"host": n.host, "description": n.description, "layers": list(n.layers)}
            for name, n in self.nodes.items()
        }

    def save(self, path: str | Path) -> None:
        with open(path, "w") as f:
            f.write(format_topology(self.to_dict()))

    # ------------------------------------------------------------- lookups

    def get_node_for_layer(self, layer_idx: int) -> Node | None:
        """The first node owning this block index."""
        for node in self.nodes.values():
            if layer_idx in node.layer_indices():
                return node
        return None

    def owner_map(self, num_layers: int) -> list[str]:
        """Per-layer owner names; unowned layers belong to the master."""
        out = []
        for i in range(num_layers):
            node = self.get_node_for_layer(i)
            out.append(node.name if node else MASTER_NODE)
        return out

    def stage_plan(self, num_layers: int) -> list[Stage]:
        """Ordered contiguous (owner, [lo, hi)) runs over all layers: one
        network hop (or one local range) each."""
        owners = self.owner_map(num_layers)
        stages: list[Stage] = []
        lo = 0
        for i in range(1, num_layers + 1):
            if i == num_layers or owners[i] != owners[lo]:
                stages.append(Stage(node=owners[lo], lo=lo, hi=i))
                lo = i
        return stages

    def replica_groups(self) -> dict[str, list[str]]:
        """``{primary: [primary, replica, ...]}`` in declaration order over
        nodes declaring the SAME layer set; the primary is the first
        declaring node, the one ``owner_map`` names."""
        by_set: dict[tuple[int, ...], list[str]] = {}
        for name, node in self.nodes.items():
            key = tuple(sorted(set(node.layer_indices())))
            if key:
                by_set.setdefault(key, []).append(name)
        return {members[0]: members for members in by_set.values()}

    def validate(self, num_layers: int) -> None:
        """Reject out-of-range layers and PARTIALLY overlapping ownership
        (identical sets are replicas, and legal)."""
        sets: dict[str, frozenset[int]] = {}
        for node in self.nodes.values():
            idxs = node.layer_indices()
            seen_own: set[int] = set()
            for idx in idxs:
                if idx >= num_layers or idx < 0:
                    raise ValueError(
                        f"{node.name}: layer {idx} out of range (model has {num_layers})"
                    )
                if idx in seen_own:
                    raise ValueError(
                        f"{node.name}: layer {idx} declared twice by the same node "
                        "(overlapping ranges)"
                    )
                seen_own.add(idx)
            sets[node.name] = frozenset(idxs)
        names = list(sets)
        for i, a in enumerate(names):
            for b in names[i + 1 :]:
                common = sets[a] & sets[b]
                if common and sets[a] != sets[b]:
                    raise ValueError(
                        f"layer {min(common)} owned by both {a} and {b} but their layer sets "
                        "differ — replicas must declare IDENTICAL ranges (partial overlap "
                        "cannot fail over)"
                    )


# ------------------------------------------------------------ file format

_NODE_KEYS = ("host", "description", "layers")
# Plain scalars YAML would read as something other than a string.
_NON_STRING = re.compile(
    r"^(~|null|Null|NULL|true|True|TRUE|false|False|FALSE|yes|Yes|YES|no|No|NO|on|On|ON"
    r"|off|Off|OFF|[-+]?(\d[\d_]*|0x[0-9a-fA-F_]+|0o[0-7_]+)|[-+]?(\d[\d_]*)?\.\d*([eE][-+]?\d+)?"
    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN))$"
)


class TopologySyntaxError(ValueError):
    def __init__(self, lineno: int, message: str):
        super().__init__(f"topology line {lineno}: {message}")


def _strip_comment(line: str) -> str:
    """The line without its comment: a ``#`` at the start or after
    whitespace, outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t:[,-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _scalar(text: str, lineno: int) -> str:
    """One scalar: double-quoted (JSON escapes), single-quoted ('' is a
    quote) or plain. A plain scalar YAML would not read as a string is
    refused: quote it."""
    text = text.strip()
    if not text:
        raise TopologySyntaxError(lineno, "missing value")
    if text[0] == '"':
        try:
            value, end = json.JSONDecoder().raw_decode(text)
        except json.JSONDecodeError as e:
            raise TopologySyntaxError(lineno, f"bad double-quoted scalar {text!r}: {e}") from None
        if end != len(text) or not isinstance(value, str):
            raise TopologySyntaxError(lineno, f"bad double-quoted scalar {text!r}")
        return value
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise TopologySyntaxError(lineno, f"unterminated single-quoted scalar {text!r}")
        body = text[1:-1]
        if "'" in body.replace("''", ""):
            raise TopologySyntaxError(lineno, f"bad single-quoted scalar {text!r}")
        return body.replace("''", "'")
    if text[0] in "[]{}&*!|>%@`,?" or text.startswith("- ") or ": " in text:
        raise TopologySyntaxError(lineno, f"unsupported value {text!r} (quote it)")
    if _NON_STRING.match(text):
        raise TopologySyntaxError(lineno, f"{text!r} is not a string in YAML (quote it)")
    return text


def _flow_list(text: str, lineno: int) -> list[str]:
    """``[a, "b", 'c']`` on one line."""
    inner = text.strip()[1:-1].strip()
    if not inner:
        return []
    items, cur, quote, i = [], "", None, 0
    while i < len(inner):
        c = inner[i]
        if quote is None and c == ",":
            items.append(cur)
            cur = ""
        else:
            if quote is None and c in "'\"" and not cur.strip():
                quote = c
            elif quote == "'" and c == "'":
                if i + 1 < len(inner) and inner[i + 1] == "'":
                    cur += c
                    i += 1
                else:
                    quote = None
            elif quote == '"' and c == "\\":
                cur += c
                i += 1
                c = inner[i] if i < len(inner) else ""
            elif quote == '"' and c == '"':
                quote = None
            cur += c
        i += 1
    items.append(cur)
    if quote is not None:
        raise TopologySyntaxError(lineno, f"unterminated quote in {text!r}")
    return [_scalar(item, lineno) for item in items]


def _key(text: str, lineno: int) -> tuple[str, str]:
    """``key: rest`` (the key plain or quoted) -> (key, rest)."""
    text = text.strip()
    if text[:1] in "'\"":
        q = text[0]
        end = 1
        while True:
            end = text.find(q, end)
            if end < 0:
                raise TopologySyntaxError(lineno, f"unterminated quoted key in {text!r}")
            if q == "'" and text[end + 1 : end + 2] == "'":
                end += 2
                continue
            if q == '"' and text[end - 1] == "\\":
                end += 1
                continue
            break
        key, rest = _scalar(text[: end + 1], lineno), text[end + 1 :]
        if not rest.startswith(":"):
            raise TopologySyntaxError(lineno, f"expected ':' after key in {text!r}")
        return key, rest[1:]
    m = re.match(r"^([^:#\s][^:]*?)\s*:(\s|$)", text)
    if m is None:
        raise TopologySyntaxError(lineno, f"expected 'key: value', got {text!r}")
    return _scalar(m.group(1), lineno), text[m.end() :]


def parse_topology(text: str) -> dict:
    """A topology file's text -> ``{name: {host, description, layers}}``,
    what ``yaml.safe_load`` gives for the schema (an empty file: {})."""
    out: dict[str, dict] = {}
    node: dict | None = None
    node_indent = None  # indent of the current node's keys
    list_key_indent = None  # indent of a ``layers:`` awaiting block items
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise TopologySyntaxError(lineno, "tab in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise TopologySyntaxError(lineno, "multi-document files are not supported")
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        if indent == 0:
            key, rest = _key(body, lineno)
            if rest.strip():
                raise TopologySyntaxError(lineno, f"node {key!r} must be a mapping of "
                                          f"{', '.join(_NODE_KEYS)}")
            if key in out:
                raise TopologySyntaxError(lineno, f"node {key!r} declared twice")
            node = out[key] = {}
            node_indent = list_key_indent = None
            continue
        if node is None:
            raise TopologySyntaxError(lineno, "indented line outside any node")
        if body.startswith("- ") or body == "-":
            if list_key_indent is None or indent < list_key_indent:
                raise TopologySyntaxError(lineno, "list item outside a 'layers:' list")
            node["layers"].append(_scalar(body[1:], lineno))
            continue
        if node_indent is None:
            node_indent = indent
        elif indent != node_indent:
            raise TopologySyntaxError(lineno, "inconsistent indentation")
        list_key_indent = None
        key, rest = _key(body, lineno)
        if key not in _NODE_KEYS:
            raise TopologySyntaxError(lineno, f"unknown node key {key!r} (the schema has "
                                      f"{', '.join(_NODE_KEYS)})")
        if key in node:
            raise TopologySyntaxError(lineno, f"key {key!r} given twice")
        rest = rest.strip()
        if key == "layers":
            if not rest:
                node["layers"] = []
                list_key_indent = indent
            elif rest.startswith("[") and rest.endswith("]"):
                node["layers"] = _flow_list(rest, lineno)
            else:
                raise TopologySyntaxError(lineno, "layers must be a list")
        else:
            node[key] = _scalar(rest, lineno)
    for name, spec in out.items():
        if "host" not in spec:
            raise ValueError(f"topology node {name!r} has no host")
    return out


def format_topology(d: dict) -> str:
    """The writer ``parse_topology`` (and YAML) reads back equal: every
    scalar double-quoted with JSON escapes."""
    lines = []
    for name, spec in d.items():
        lines.append(f"{json.dumps(str(name))}:")
        lines.append(f"  host: {json.dumps(str(spec['host']))}")
        lines.append(f"  description: {json.dumps(str(spec.get('description', '')))}")
        layers = list(spec.get("layers", []))
        if not layers:
            lines.append("  layers: []")
            continue
        lines.append("  layers:")
        lines.extend(f"    - {json.dumps(str(item))}" for item in layers)
    return "\n".join(lines) + "\n"
