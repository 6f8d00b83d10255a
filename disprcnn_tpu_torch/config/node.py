"""Minimal yacs-compatible hierarchical config node (counterpart of
disprcnn_tpu/config/node.py), with its own reader of the YAML the configs
use.

The machine with the card has no PyYAML, so ``merge_from_file`` reads the
files with ``load_yaml``, a reader of the subset of YAML that
``configs/`` is written in:

- block maps nested by indentation (spaces), and ``#`` comments;
- inline ``[...]`` lists, nested (as in ``MEAN_SIZE: [[1.5, 1.6, 3.9]]``);
- quoted strings without escapes (no backslash in double quotes, no
  doubled single quote);
- plain scalars: ``True`` and ``False``, decimal ints, floats with a dot
  (``0.60``, ``1.0e-4``; ``1e-4``, with no dot, is a string, as PyYAML
  reads it), and every other plain scalar that PyYAML's ``safe_load``
  reads as a string, such as ``(600,)``, which the coercion below hands
  to ``ast.literal_eval`` as the JAX package's does.

Anything outside the subset raises ``ValueError`` naming the line: block
sequences, flow maps, anchors, tags, block scalars, documents, tabs, and
every plain scalar that PyYAML (YAML 1.1) would read as something other
than a string and the subset does not hold (``yes``, ``off``, ``~``,
``null``, ``010``, ``0x1F``, ``1_000``, ``1:30``, ``.5``, ``.inf``).
``dump`` imports PyYAML lazily; nothing on the card calls it.
"""
from __future__ import annotations

import ast
import copy
import re
from typing import Any, List


class CfgNode(dict):
    """A dict with attribute access, freezing, and YAML merge — yacs-compatible subset."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Attempted to set {name} on immutable CfgNode")
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Attempted to set {name} on immutable CfgNode")
        dict.__setitem__(self, name, value)

    # -- mutability --------------------------------------------------------
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- merging -----------------------------------------------------------
    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            loaded = load_yaml(f.read(), path) or {}
        self._merge(CfgNode(loaded), self, [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge(other, self, [])

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list must have even length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                assert p in node, f"Unknown config key: {key}"
                node = node[p]
            leaf = parts[-1]
            assert leaf in node, f"Unknown config key: {key}"
            node[leaf] = _coerce(value, node[leaf], key)

    @staticmethod
    def _merge(src: "CfgNode", dst: "CfgNode", path: List[str]) -> None:
        for k, v in src.items():
            full = ".".join(path + [k])
            if k not in dst:
                # yacs raises on unknown keys; we do too, to catch typos early.
                raise KeyError(f"Unknown config key: {full}")
            if isinstance(v, CfgNode):
                if not isinstance(dst[k], CfgNode):
                    raise TypeError(f"Cannot merge dict into non-dict at {full}")
                CfgNode._merge(v, dst[k], path + [k])
            else:
                dst[k] = _coerce(v, dst[k], full)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=True)

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"

    def __deepcopy__(self, memo):
        out = CfgNode()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def __reduce__(self):
        return (CfgNode, (self.to_dict(),))


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce an override to the type of the default (yacs behavior)."""
    if isinstance(value, str) and not isinstance(old, str):
        value = _parse_literal(value)
    if isinstance(value, list):
        value = tuple(value) if isinstance(old, tuple) else value
    if old is None or value is None:
        return value
    if isinstance(old, bool) and isinstance(value, int):
        return bool(value)
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if type(old) is not type(value) and not (
        isinstance(old, (list, tuple)) and isinstance(value, (list, tuple))
    ):
        raise TypeError(
            f"Type mismatch for key {key}: default {type(old).__name__}, "
            f"override {type(value).__name__}"
        )
    return value


def _parse_literal(s: str) -> Any:
    """A Python literal, else the string read as one YAML value of the
    subset, else the string itself; raises on a scalar that PyYAML would
    read as something other than a string and the subset does not hold."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        pass
    try:
        return parse_value(s.strip(), "<override>", 0)
    except ValueError:
        if _NOT_A_STRING.match(s.strip()):
            raise
        return s


# -- the YAML subset ----------------------------------------------------------
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")
# the plain scalars that PyYAML's YAML 1.1 implicit resolvers
# (yaml/resolver.py) read as booleans, ints, floats or nulls
_NOT_A_STRING = re.compile(r"""^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE
                           |on|On|ON|off|Off|OFF|~|null|Null|NULL
                           |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)
                           |[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
                           |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                           |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                           |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                           |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$""", re.X)
_KEY = re.compile(r"""^(?P<key>"[^"]*"|'[^']*'|[^\s"'#\[\]{},&*!|>%@`-][^:#]*?)
                      \s*:(?:\s+(?P<value>.*))?$""", re.X)


def resolve_plain(s: str, where: str) -> Any:
    """A plain scalar of the subset, as PyYAML's safe_load resolves it."""
    if s in ("True", "False"):
        return s == "True"
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if _NOT_A_STRING.match(s):
        raise ValueError(f"{where}: plain scalar outside the YAML subset: {s!r}")
    return s


def _unquote(s: str, where: str) -> str:
    if s[0] == '"' and "\\" in s:
        raise ValueError(f"{where}: escape outside the YAML subset in {s}")
    return s[1:-1]


def _quoted_end(s: str, i: int) -> int:
    """Index just past the quoted string that starts at s[i] (the subset
    has no escapes: the next quote of its kind ends it)."""
    j = s.find(s[i], i + 1)
    if j < 0:
        raise ValueError(f"unterminated quoted string: {s}")
    return j + 1


def _flow_items(s: str, where: str) -> List[Any]:
    """The items of one flow sequence "[...]"."""
    inner = s[1:-1]
    items, depth, start, i = [], 0, 0, 0
    while i < len(inner):
        c = inner[i]
        if c in "\"'":
            i = _quoted_end(inner, i)
            continue
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        elif c in "{}":
            raise ValueError(f"{where}: flow map outside the YAML subset")
        elif c == "," and depth == 0:
            items.append(inner[start:i])
            start = i + 1
        i += 1
    last = inner[start:]
    if last.strip() or items:
        items.append(last)
    if items and not items[-1].strip():  # a trailing comma
        items.pop()
    out = []
    for item in items:
        item = item.strip()
        if not item:
            raise ValueError(f"{where}: empty item in {s}")
        out.append(parse_value(item, where, 0, flow=True))
    return out


def parse_value(s: str, where: str, lineno: int, flow: bool = False) -> Any:
    """One value of the subset (comments already taken off)."""
    at = f"{where}:{lineno}" if lineno else where
    if not s:
        return None
    if s[0] == "[":
        if not _balanced(s) or s[-1] != "]":
            raise ValueError(f"{at}: flow sequence outside the YAML subset: {s}")
        return _flow_items(s, at)
    if s[0] in "\"'":
        if _quoted_end(s, 0) != len(s):
            raise ValueError(f"{at}: text after a quoted string: {s}")
        return _unquote(s, at)
    if s[0] in "{&*!|>%@`-?" and not (s[0] == "-" and len(s) > 1 and s[1] not in " \t"):
        raise ValueError(f"{at}: construct outside the YAML subset: {s}")
    if ": " in s or s.endswith(":") or (flow and any(c in s for c in "[]{}")):
        raise ValueError(f"{at}: construct outside the YAML subset: {s}")
    return resolve_plain(s, at)


def _balanced(s: str) -> bool:
    depth, i = 0, 0
    while i < len(s):
        if s[i] in "\"'":
            i = _quoted_end(s, i)
            continue
        depth += {"[": 1, "]": -1}.get(s[i], 0)
        if depth < 0:
            return False
        i += 1
    return depth == 0


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at its start or after a space,
    outside quotes."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "\"'" and (i == 0 or line[i - 1] in " \t[,:"):
            i = _quoted_end(line, i)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def load_yaml(text: str, where: str = "<string>") -> Any:
    """Read a document of the subset into dicts, lists and scalars, as
    yaml.safe_load would; None for an empty document."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{where}:{n}: tab in indentation")
        try:
            body = _strip_comment(raw)
        except ValueError as e:
            raise ValueError(f"{where}:{n}: {e}") from None
        if not body.strip():
            continue
        if body.startswith(("---", "...", "%")):
            raise ValueError(f"{where}:{n}: document marker outside the YAML subset")
        lines.append((n, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    root, pos = _block_map(lines, 0, lines[0][1], where)
    if pos != len(lines):
        n = lines[pos][0]
        raise ValueError(f"{where}:{n}: bad indentation")
    return root


def _block_map(lines, pos: int, indent: int, where: str):
    out = {}
    while pos < len(lines):
        n, ind, body = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"{where}:{n}: bad indentation")
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"{where}:{n}: not a 'key: value' line of the YAML subset: {body}")
        key = m.group("key")
        at = f"{where}:{n}"
        key = _unquote(key, at) if key[0] in "\"'" else resolve_plain(key, at)
        value = m.group("value")
        pos += 1
        if value is None or not value.strip():
            if pos < len(lines) and lines[pos][1] > indent:
                out[key], pos = _block_map(lines, pos, lines[pos][1], where)
            else:
                out[key] = None
        else:
            out[key] = parse_value(value.strip(), where, n)
    return out, pos
