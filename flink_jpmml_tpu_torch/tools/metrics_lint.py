"""Metric-name and fleet-merge-rule lint of the port (tier-1 via
tests/test_torch_metrics_lint.py)::

    python -m flink_jpmml_tpu_torch.tools.metrics_lint
        [--src DIR] [--docs FILE] [--deltas FILE]

The port's twin of the JAX repo's ``tools/metrics_lint.py``, with its
two contracts, both static (regex and ``ast`` level, no import of the
package, so no code path a test happened to run can skew them):

1. **Name sync**: every metric name the port registers is catalogued,
   and every catalogued name is registered. The catalogue is the
   operator catalogue of ``docs/operations.md`` ("### Metric name
   catalogue"), read as it stands, with the port's own delta table
   (``tools/metric_deltas.md``) applied: its ``emitted`` rows add the
   names the port registers and the catalogue lacks, its
   ``not-registered`` rows drop the catalogued names the port never
   registers.
2. **Merge-rule sync**: every row (the delta table's ``emitted`` rows
   too) declares its fleet-merge semantics (counters ``sum``, histograms
   and sketches ``buckets``, gauges ``sum`` / ``min`` / ``max`` /
   ``worst-of``), and each gauge's matches what the port's
   ``utils/metrics.py merge_structs`` does (its
   ``_GAUGE_MERGE_MAX_PREFIXES`` / ``_GAUGE_MERGE_MIN_PREFIXES`` tables,
   parsed from source); every prefix rule is exercised by a gauge row;
   the governor's ``_RANK_FAMILY_DEFAULT`` names a catalogued family.

What differs from the JAX lint: the source tree is the port's, and the
delta table is new. A delta row that no longer applies is drift too, so
the table cannot rot: an ``emitted`` name the catalogue now has or the
port no longer registers, a ``not-registered`` name the port now
registers or the catalogue no longer has.

Every ``.counter(<name>)`` / ``.gauge(<name>)`` / ``.histogram(...)`` /
``.reservoir(...)`` / ``.sketch(...)`` call with a literal (or
f-string-literal) first argument is an emission site; f-string
placeholders normalize to ``*``, the catalogue's wildcard for dynamic
segments.

Exit 0 = in sync; 1 = drift (each direction listed, with file:line for
emission sites); 2 = the catalogue or the delta table could not be read
(the structure changed under the lint: fix the parser, don't drop the
contract).
"""

from __future__ import annotations

import argparse
import ast
import pathlib
import re
import sys
from typing import Dict, List, Optional, Set, Tuple

SRC = pathlib.Path(__file__).resolve().parent.parent
REPO = SRC.parent
DOCS = REPO / "docs" / "operations.md"
DELTAS = SRC / "tools" / "metric_deltas.md"

# .counter(<literal>) / .gauge(<f-string literal>): single or double quoted
_CALL = re.compile(
    r"\.(counter|gauge|histogram|reservoir|sketch)"
    r"\(\s*(f?)(\"([^\"]+)\"|'([^']+)')"
)
_CATALOGUE_HEAD = "### Metric name catalogue"
_ROW = re.compile(
    r"^\|\s*`([^`]+)`\s*\|\s*([a-z]+)\s*\|\s*([a-z-]+)\s*\|"
)
_DELTA_ROW = re.compile(
    r"^\|\s*`([^`]+)`\s*\|\s*([a-z]+)\s*\|\s*([a-z-]+)\s*\|"
    r"\s*([a-z-]+)\s*\|\s*(.*?)\s*\|\s*$"
)
EMITTED = "emitted"
NOT_REGISTERED = "not-registered"
_PREFIX_TABLE_NAMES = (
    "_GAUGE_MERGE_MAX_PREFIXES", "_GAUGE_MERGE_MIN_PREFIXES",
)

# what the Merge column may say, per kind; gauges are checked against
# the CODE's merge mode below, not just this vocabulary
_MERGE_VOCAB = {
    "counter": {"sum"},
    "histogram": {"buckets"},
    "sketch": {"buckets"},
    "gauge": {"sum", "max", "min", "worst-of"},
    "reservoir": {"none"},
}


class Unreadable(Exception):
    """The catalogue, the delta table or ``utils/metrics.py`` could not
    be parsed: exit 2."""


def _normalize_fstring(s: str) -> str:
    """f-string literal → catalogue wildcard form: ``{{``/``}}`` are
    literal braces, any ``{expr}`` placeholder becomes ``*``."""
    s = s.replace("{{", "\x00").replace("}}", "\x01")
    s = re.sub(r"\{[^{}]*\}", "*", s)
    return s.replace("\x00", "{").replace("\x01", "}")


def code_names(src: pathlib.Path) -> Set[Tuple[str, str, str]]:
    """→ {(name, kind, 'file:line')} for every literal registration site
    under ``src`` (paths relative to its parent)."""
    out: Set[Tuple[str, str, str]] = set()
    for path in sorted(src.rglob("*.py")):
        text = path.read_text(encoding="utf-8")
        for m in _CALL.finditer(text):
            kind = m.group(1)
            is_f = bool(m.group(2))
            raw = m.group(4) if m.group(4) is not None else m.group(5)
            name = _normalize_fstring(raw) if is_f else raw
            line = text.count("\n", 0, m.start()) + 1
            out.add((name, kind, f"{path.relative_to(src.parent)}:{line}"))
    return out


def _module_assigns(path: pathlib.Path) -> Dict[str, object]:
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError) as e:
        raise Unreadable(
            f"{path} does not parse ({e}): fix the module, the lint reads "
            f"its assignments") from e
    out: Dict[str, object] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                try:
                    out[target.id] = ast.literal_eval(node.value)
                except (SyntaxError, ValueError):
                    continue
    return out


def gauge_merge_prefixes(path: pathlib.Path) -> Dict[str, Tuple[str, ...]]:
    """The merge prefix tables of ``utils/metrics.py`` (via ``ast``)."""
    assigns = _module_assigns(path)
    out = {
        name: tuple(assigns[name]) for name in _PREFIX_TABLE_NAMES
        if isinstance(assigns.get(name), (tuple, list))
        and all(isinstance(s, str) for s in assigns[name])
    }
    missing = [n for n in _PREFIX_TABLE_NAMES if n not in out]
    if missing:
        raise Unreadable(
            f"could not parse the gauge merge prefix table(s) {missing} "
            f"from {path}: fix the parser, don't drop the contract")
    return out


def rank_family_default(path: pathlib.Path) -> str:
    """``_RANK_FAMILY_DEFAULT`` (the cardinality governor's default
    top-K ranking family) of ``utils/metrics.py``."""
    value = _module_assigns(path).get("_RANK_FAMILY_DEFAULT")
    if not isinstance(value, str):
        raise Unreadable(
            f"_RANK_FAMILY_DEFAULT not found in {path}: fix the parser, "
            f"don't drop the contract")
    return value


def _code_gauge_mode(name: str, prefixes: Dict[str, Tuple[str, ...]]) -> str:
    """What merge_structs does to this gauge (min checked first, as in
    the code)."""
    base = name.split("{", 1)[0]
    if base.startswith(prefixes["_GAUGE_MERGE_MIN_PREFIXES"]):
        return "min"
    if base.startswith(prefixes["_GAUGE_MERGE_MAX_PREFIXES"]):
        return "max"
    return "sum"


def _table_lines(text: str) -> List[str]:
    """The first markdown table of ``text``: its ``|`` lines up to the
    first other line after them."""
    lines, in_table = [], False
    for line in text.splitlines():
        if line.startswith("|"):
            in_table = True
            lines.append(line)
        elif in_table:
            break
    return lines


def doc_rows(docs: pathlib.Path) -> Dict[str, Tuple[str, str]]:
    """→ {name: (kind, merge)} from the catalogue table."""
    try:
        text = docs.read_text(encoding="utf-8")
    except OSError as e:
        raise Unreadable(f"cannot read {docs}: {e}") from e
    if _CATALOGUE_HEAD not in text:
        raise Unreadable(f"{_CATALOGUE_HEAD!r} section not found in {docs}")
    rows: Dict[str, Tuple[str, str]] = {}
    for line in _table_lines(text.split(_CATALOGUE_HEAD, 1)[1]):
        m = _ROW.match(line)
        if m and m.group(1) != "Name":
            rows[m.group(1)] = (m.group(2), m.group(3))
    if not rows:
        raise Unreadable(
            f"catalogue table empty/unparseable in {docs} (each row "
            f"needs | `name` | kind | merge | meaning |)")
    return rows


def delta_rows(deltas: pathlib.Path) -> Dict[str, Tuple[str, str, str, str]]:
    """→ {name: (kind, merge, delta, reason)} from the port's delta
    table; every row needs a known delta and a reason."""
    try:
        text = deltas.read_text(encoding="utf-8")
    except OSError as e:
        raise Unreadable(f"cannot read {deltas}: {e}") from e
    lines = _table_lines(text)
    if not lines:
        raise Unreadable(f"no delta table in {deltas}")
    rows: Dict[str, Tuple[str, str, str, str]] = {}
    for line in lines[2:]:  # the header and its rule
        m = _DELTA_ROW.match(line)
        if (m is None or m.group(4) not in (EMITTED, NOT_REGISTERED)
                or not m.group(5)):
            raise Unreadable(
                f"unparseable delta row in {deltas}: {line!r} (each row "
                f"needs | `name` | kind | merge | emitted|not-registered "
                f"| reason |)")
        rows[m.group(1)] = m.group(2, 3, 4, 5)
    return rows


def check(src: pathlib.Path = SRC, docs: pathlib.Path = DOCS,
          deltas: pathlib.Path = DELTAS) -> Tuple[List[str], int]:
    """→ (drift lines, count of names emitted); raises ``Unreadable``."""
    metrics_py = src / "utils" / "metrics.py"
    emitted = code_names(src)
    catalogue = doc_rows(docs)
    delta = delta_rows(deltas)
    prefixes = gauge_merge_prefixes(metrics_py)
    rank = rank_family_default(metrics_py)
    emitted_names = {n for n, _, _ in emitted}
    out: List[str] = []
    where = deltas.name

    # -- the delta table: every row still applies --------------------------
    for name, (kind, merge, change, _) in sorted(delta.items()):
        if change == EMITTED and name in catalogue:
            out.append(f"`{name}` is an `emitted` row of {where}, but the "
                       f"catalogue now has it: drop the row")
        if change == EMITTED and name not in emitted_names:
            out.append(f"`{name}` is an `emitted` row of {where}, but "
                       f"nothing in {src.name}/ registers it: drop the row")
        if change == NOT_REGISTERED and name in emitted_names:
            sites = sorted(s for n, _, s in emitted if n == name)
            out.append(f"`{name}` is a `not-registered` row of {where}, "
                       f"but the port registers it ({', '.join(sites)}): "
                       f"drop the row")
        if change == NOT_REGISTERED and name not in catalogue:
            out.append(f"`{name}` is a `not-registered` row of {where}, "
                       f"but the catalogue no longer has it: drop the row")
    documented = {n: r for n, r in catalogue.items()
                  if delta.get(n, (None,) * 3)[2] != NOT_REGISTERED}
    documented.update({n: (k, m) for n, (k, m, change, _) in delta.items()
                       if change == EMITTED and n not in catalogue})

    # -- direction 1: every emission site documented, and back -------------
    for n in sorted(emitted_names - set(documented)):
        sites = sorted(s for name, _, s in emitted if name == n)
        out.append(f"`{n}` is emitted ({', '.join(sites)}) but missing "
                   f"from the docs/operations.md catalogue and from "
                   f"{where}")
    for n in sorted(set(documented) - emitted_names):
        out.append(f"`{n}` is in the docs/operations.md catalogue but "
                   f"nothing in {src.name}/ registers it (and {where} has "
                   f"no `not-registered` row for it)")

    # -- direction 2: merge declarations match the code --------------------
    for name, (kind, merge) in sorted(documented.items()):
        vocab = _MERGE_VOCAB.get(kind)
        if vocab is None:
            out.append(f"`{name}` has unknown kind {kind!r} (one of "
                       f"{sorted(_MERGE_VOCAB)})")
            continue
        if merge not in vocab:
            out.append(f"`{name}` ({kind}) declares merge {merge!r}; a "
                       f"{kind}'s merge must be one of {sorted(vocab)}")
            continue
        if kind == "gauge":
            mode = _code_gauge_mode(name, prefixes)
            if not (merge == mode
                    or (merge == "worst-of" and mode in ("max", "min"))):
                out.append(f"`{name}` declares merge {merge!r} but "
                           f"utils/metrics.merge_structs {mode}s it: fix "
                           f"the row or the _GAUGE_MERGE_*_PREFIXES tables")

    # -- direction 3: every prefix rule exercised by a gauge row -----------
    doc_gauges = [name.split("{", 1)[0]
                  for name, (kind, _) in documented.items()
                  if kind == "gauge"]
    for table in _PREFIX_TABLE_NAMES:
        for prefix in prefixes[table]:
            if not any(g.startswith(prefix) for g in doc_gauges):
                out.append(f"merge prefix {prefix!r} in utils/metrics.py "
                           f"{table} matches no catalogue gauge row: dead "
                           f"rule or missing documentation")

    # -- direction 4: the governor's default rank family is real -----------
    if rank not in {name.split("{", 1)[0] for name in documented}:
        out.append(f"governor rank family {rank!r} (_RANK_FAMILY_DEFAULT, "
                   f"utils/metrics.py) names no catalogued metric base")
    return out, len(emitted_names)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flink_jpmml_tpu_torch.tools.metrics_lint")
    ap.add_argument("--src", type=pathlib.Path, default=SRC,
                    help="the port's package directory")
    ap.add_argument("--docs", type=pathlib.Path, default=DOCS,
                    help="the operator catalogue (docs/operations.md)")
    ap.add_argument("--deltas", type=pathlib.Path, default=DELTAS,
                    help="the port's delta table (tools/metric_deltas.md)")
    args = ap.parse_args(argv)
    try:
        drift, n = check(args.src, args.docs, args.deltas)
    except Unreadable as e:
        print(f"metrics-lint: {e}", file=sys.stderr)
        return 2
    for line in drift:
        print(f"metrics-lint: {line}")
    if drift:
        return 1
    print(f"metrics-lint: {n} metric names in sync with the catalogue and "
          f"the port's delta table (merge rules + governor rank family "
          f"verified)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
