"""Experiment configs: the YAML files of ``configs/`` without PyYAML.

Counterpart of ``lanczosnet_tpu/utils/config.py``: the same keys, the
same run identity (``run_id``, ``save_dir = exp_dir/exp_name/run_id``,
the config written into the run directory as ``config.yaml``) and the
same ``-c/-l/-m/-t`` flags. The machine the port runs on has no YAML
library, so this module reads the subset of YAML that the configs use,
and writes ``config.yaml`` in that subset:

- block mappings by indentation, with keys of letters, digits, ``_``,
  ``.`` and ``-``;
- block sequences of scalars (``- 15``), indented or not;
- flow lists of scalars (``[15, 25]``), and ``[]`` and ``{}``;
- ``#`` comments, whole-line or trailing;
- ``null``, ``true``, ``false``; decimal ints; floats with a point
  (``1.0e-3``, ``0.5``);
- bare strings, and single-quoted strings (``''`` is a quote).

Anything else raises ``ValueError`` naming the line: a scalar that YAML
1.1 would read as something this reader does not give (``yes``, ``~``,
``1e-3``, ``0x10``, ``.inf``, a date) is refused rather than read
another way than PyYAML reads it.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from pathlib import Path
from typing import Any

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?\Z")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.-]*\Z")
# a plain scalar that starts like a number, or names a YAML 1.1 value
_NUMBER_LIKE = re.compile(r"[-+]?\.?[0-9]|[-+]?\.(?:inf|nan)\Z", re.IGNORECASE)
# what PyYAML's implicit resolvers read as an int, a float or a date, and
# a float without a point (a string to YAML 1.1, a number to YAML 1.2): a
# number-like plain scalar that matches none of these is a string, as
# ``yaml.safe_dump`` writes one (``run_id: 20261017_012345_42_train``)
_TYPED = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:(?:[Tt]|[ \t]+)[0-9].*)?"
    r"|[-+]?[0-9][0-9_]*(?:\.[0-9_]*)?[eE][-+]?[0-9]+\Z"
)
_RESERVED = {"yes", "no", "on", "off", "true", "false", "null", "~", "y", "n"}
_INDICATORS = "-?:,[]{}#&*!|>'\"%@`"
_SAFE_BARE = re.compile(r"[A-Za-z_/][A-Za-z0-9_./-]*\Z")


class AttrDict(dict):
    """dict with attribute access, applied recursively by ``convert``."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def convert(obj: Any) -> Any:
        if isinstance(obj, dict):
            return AttrDict({k: AttrDict.convert(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(AttrDict.convert(v) for v in obj)
        return obj

    def to_plain(self) -> dict:
        def conv(o):
            if isinstance(o, dict):
                return {k: conv(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [conv(v) for v in o]
            return o

        return conv(self)


def _fail(lineno: int, msg: str) -> ValueError:
    return ValueError(f"line {lineno}: {msg} (outside the YAML subset of configs/*.yaml)")


def _strip_comment(line: str, lineno: int) -> str:
    """The line without its comment: ``#`` at the start or after a blank,
    outside single quotes."""
    quoted = False
    for i, ch in enumerate(line):
        if ch == "'":
            quoted = not quoted
        elif ch == "#" and not quoted and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    if quoted:
        raise _fail(lineno, "unterminated single-quoted string")
    return line.rstrip()


def _scalar(tok: str, lineno: int) -> Any:
    tok = tok.strip()
    if tok.startswith("'"):
        if len(tok) < 2 or not tok.endswith("'") or "'" in tok[1:-1].replace("''", ""):
            raise _fail(lineno, f"malformed single-quoted string {tok!r}")
        return tok[1:-1].replace("''", "'")
    if tok == "null":
        return None
    if tok in ("true", "false"):
        return tok == "true"
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if tok == "[]":
        return []
    if tok == "{}":
        return {}
    if (
        not tok
        or tok.lower() in _RESERVED
        or (_NUMBER_LIKE.match(tok) and (_TYPED.fullmatch(tok) or not tok[-1].isalpha()))
        or tok[0] in _INDICATORS
        or ": " in tok
        or tok.endswith(":")
        or any(c in tok for c in ",[]{}\"\t")
    ):
        raise _fail(lineno, f"scalar {tok!r}")
    return tok


def _flow_list(text: str, lineno: int) -> list:
    inner = text[1:-1].strip()
    if not inner:
        return []
    items, cur, quoted = [], "", False
    for ch in inner:
        if ch == "'":
            quoted = not quoted
        if ch == "," and not quoted:
            items.append(cur)
            cur = ""
        else:
            cur += ch
    items.append(cur)
    out = []
    for item in items:
        item = item.strip()
        if item[:1] in ("[", "{"):
            raise _fail(lineno, "nested flow collection")
        out.append(_scalar(item, lineno))
    return out


def _value(text: str, lineno: int) -> Any:
    if text.startswith("[") and text != "[]":
        if not text.endswith("]"):
            raise _fail(lineno, f"flow list {text!r}")
        return _flow_list(text, lineno)
    return _scalar(text, lineno)


def _block(lines: list, i: int, indent: int) -> tuple[Any, int]:
    """Parse the block of ``lines`` that starts at ``i`` at ``indent``
    spaces → (value, index of the first line after it)."""
    if lines[i][2].startswith("- ") or lines[i][2] == "-":
        out = []
        while i < len(lines) and lines[i][1] == indent and lines[i][2][:1] == "-":
            lineno, _, text = lines[i]
            item = text[1:].strip()
            if not text.startswith("- ") or not item or (": " in item or item.endswith(":")):
                raise _fail(lineno, "a sequence item must be a scalar or a flow list")
            out.append(_value(item, lineno))
            i += 1
        return out, i
    out = {}
    while i < len(lines) and lines[i][1] == indent:
        lineno, _, text = lines[i]
        key, sep, rest = text.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise _fail(lineno, f"expected 'key: value', got {text!r}")
        key = key.strip()
        if not _KEY.match(key) or key.lower() in _RESERVED:
            raise _fail(lineno, f"key {key!r}")
        if key in out:
            raise _fail(lineno, f"duplicate key {key!r}")
        rest = rest.strip()
        i += 1
        if rest:
            out[key] = _value(rest, lineno)
        elif i < len(lines) and (
            lines[i][1] > indent or (lines[i][1] == indent and lines[i][2][:1] == "-")
        ):
            out[key], i = _block(lines, i, lines[i][1])
        else:
            out[key] = None
    if i < len(lines) and lines[i][1] > indent:
        raise _fail(lines[i][0], "unexpected indentation")
    return out, i


def loads(text: str) -> dict:
    """The mapping a config's text describes (see the module docstring
    for what it may hold)."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise _fail(lineno, "tab in indentation")
        line = _strip_comment(raw, lineno)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise _fail(lineno, "document marker")
        lines.append((lineno, len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        raise ValueError("empty config")
    if lines[0][2][:1] == "-":
        raise _fail(lines[0][0], "the document must be a mapping")
    out, i = _block(lines, 0, lines[0][1])
    if i < len(lines):
        raise _fail(lines[i][0], "unexpected dedent")
    return out


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        text = repr(v)
        if not (v == v and abs(v) != float("inf")):
            raise ValueError(f"float {v} has no form in the config subset")
        if "." not in text:  # 1e-05 → 1.0e-05: YAML 1.1 reads a float with a point
            mant, _, exp = text.partition("e")
            text = f"{mant}.0e{exp}" if exp else f"{mant}.0"
        return text
    if isinstance(v, str):
        if "\n" in v or "\r" in v:
            raise ValueError(f"string {v!r} spans lines; the config subset has no form for it")
        if _SAFE_BARE.match(v) and v.lower() not in _RESERVED:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"value {v!r} of type {type(v).__name__} has no form in the config subset")


def dumps(cfg: dict) -> str:
    """``cfg`` as text in the subset ``loads`` reads; PyYAML reads it to
    the same mapping."""
    out = []

    def emit(d: dict, indent: int) -> None:
        for key, val in d.items():
            if not isinstance(key, str) or not _KEY.match(key) or key.lower() in _RESERVED:
                raise ValueError(f"key {key!r} has no form in the config subset")
            pad = " " * indent
            if isinstance(val, dict) and val:
                out.append(f"{pad}{key}:")
                emit(val, indent + 2)
            elif isinstance(val, dict):
                out.append(f"{pad}{key}: {{}}")
            elif isinstance(val, (list, tuple)):
                if any(isinstance(x, (dict, list, tuple)) for x in val):
                    raise ValueError(f"{key}: only lists of scalars have a form in the subset")
                out.append(f"{pad}{key}: [{', '.join(_dump_scalar(x) for x in val)}]")
            else:
                out.append(f"{pad}{key}: {_dump_scalar(val)}")

    emit(cfg, 0)
    return "\n".join(out) + "\n"


def load_config(
    path: str | Path,
    is_test: bool = False,
    make_run_dir: bool = True,
    comment: str = "",
) -> AttrDict:
    """Read a config and mint its run identity."""
    cfg = AttrDict.convert(loads(Path(path).read_text()))
    cfg.setdefault("seed", 1234)
    cfg.setdefault("exp_name", Path(path).stem)
    cfg.is_test = is_test
    tag = "test" if is_test else "train"
    cfg.run_id = f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}_{tag}"
    if comment:
        cfg.comment = comment
    base = cfg.get("exp_dir", "exp")
    cfg.save_dir = str(Path(base) / cfg.exp_name / cfg.run_id)
    if make_run_dir:
        Path(cfg.save_dir).mkdir(parents=True, exist_ok=True)
        save_config(cfg, Path(cfg.save_dir) / "config.yaml")
    return cfg


def save_config(cfg: dict, path: str | Path) -> None:
    plain = cfg.to_plain() if isinstance(cfg, AttrDict) else cfg
    Path(path).write_text(dumps(plain))


def parse_arguments(argv=None) -> argparse.Namespace:
    """The flags of ``run_exp.py``."""
    p = argparse.ArgumentParser(description="lanczosnet_torch experiment runner")
    p.add_argument("-c", "--config_file", required=True, help="path to YAML config")
    p.add_argument("-l", "--log_level", default="INFO", help="logging level")
    p.add_argument("-m", "--comment", default="", help="run comment")
    p.add_argument(
        "-t", "--test", action="store_true", help="run evaluation instead of training"
    )
    p.add_argument("--device", default=None,
                   help="the device to run on (default: the card; 'cpu' where asked)")
    return p.parse_args(argv)
