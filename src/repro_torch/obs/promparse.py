"""A strict mini-parser for the Prometheus text exposition format (the
port's own copy of ``repro.obs.promparse``).

This is the *validator* half of ``Registry.prometheus_text()``: the tests
and ``chip_smoke.py`` parse the rendered exposition (and a ``/metrics``
scrape) back with it instead of grepping for substrings, so escaping
bugs, HELP/TYPE ordering bugs and histogram inconsistencies fail
loudly.  It deliberately implements only what the registry emits (and
what a scrape endpoint must get right):

  * comment discipline — every family has exactly one ``# HELP`` and one
    ``# TYPE``, HELP first, both before any of the family's samples, and
    a family's samples are contiguous (no interleaving);
  * label parsing with full value UN-escaping (``\\\\``, ``\\"``,
    ``\\n``) via a character-level scanner, not a regex that a quote in
    a label value would defeat;
  * histogram consistency — ``_bucket`` series are cumulative and
    non-decreasing in ``le`` order, the ``+Inf`` bucket equals
    ``_count``, and ``_sum``/``_count`` exist per label set;
  * summary consistency — ``quantile`` labels are floats in [0, 1].

``parse`` raises :class:`ValueError` with the offending line number on
any violation; on success it returns ``{family: Family}`` for structured
assertions.
"""

from __future__ import annotations

import dataclasses
import math

_SUFFIXES = {
    "histogram": ("_bucket", "_sum", "_count"),
    "summary": ("", "_sum", "_count"),
    "counter": ("",),
    "gauge": ("",),
    "untyped": ("",),
}


@dataclasses.dataclass
class Sample:
    name: str                       # full sample name (with suffix)
    labels: dict[str, str]
    value: float
    line: int


@dataclasses.dataclass
class Family:
    name: str
    help: str
    type: str
    samples: list[Sample] = dataclasses.field(default_factory=list)

    def series(self, suffix: str = "") -> dict[tuple, float]:
        """``{sorted-label-items: value}`` for one suffix's samples."""
        return {tuple(sorted(s.labels.items())): s.value
                for s in self.samples if s.name == self.name + suffix}


def _unescape(raw: str, line_no: int) -> str:
    out, i = [], 0
    while i < len(raw):
        c = raw[i]
        if c == "\\":
            if i + 1 >= len(raw):
                raise ValueError(f"line {line_no}: dangling backslash")
            nxt = raw[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ValueError(
                    f"line {line_no}: bad escape \\{nxt} in label value")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(body: str, line_no: int) -> dict[str, str]:
    """Scan ``name="value",...`` with escaping; ``body`` excludes braces."""
    labels: dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.find("=", i)
        if eq < 0:
            raise ValueError(f"line {line_no}: label without '='")
        name = body[i:eq].strip()
        if not name.replace("_", "a").isalnum():
            raise ValueError(f"line {line_no}: bad label name {name!r}")
        if eq + 1 >= len(body) or body[eq + 1] != '"':
            raise ValueError(f"line {line_no}: unquoted label value")
        j = eq + 2
        while j < len(body):                 # find the closing quote,
            if body[j] == "\\":              # skipping escaped chars
                j += 2
            elif body[j] == '"':
                break
            else:
                j += 1
        if j >= len(body) or body[j] != '"':
            raise ValueError(f"line {line_no}: unterminated label value")
        if name in labels:
            raise ValueError(f"line {line_no}: duplicate label {name!r}")
        labels[name] = _unescape(body[eq + 2:j], line_no)
        i = j + 1
        if i < len(body):
            if body[i] != ",":
                raise ValueError(
                    f"line {line_no}: expected ',' between labels")
            i += 1
    return labels


def _parse_sample(line: str, line_no: int) -> Sample:
    brace = line.find("{")
    if brace >= 0:
        close = line.rfind("}")
        if close < brace:
            raise ValueError(f"line {line_no}: unbalanced braces")
        name = line[:brace]
        labels = _parse_labels(line[brace + 1:close], line_no)
        rest = line[close + 1:].strip()
    else:
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise ValueError(f"line {line_no}: sample missing value")
        name, rest = parts[0], parts[1]
        labels = {}
    if not name or not name.replace("_", "a").replace(":", "a").isalnum():
        raise ValueError(f"line {line_no}: bad metric name {name!r}")
    val = rest.split()[0] if rest.split() else ""
    try:
        value = float(val.replace("+Inf", "inf").replace("-Inf", "-inf"))
    except ValueError:
        raise ValueError(f"line {line_no}: bad sample value {val!r}")
    return Sample(name=name, labels=labels, value=value, line=line_no)


def _family_of(sample_name: str, families: dict[str, Family]) -> Family | None:
    """Longest-prefix match of a sample name onto a declared family,
    honoring the family type's legal suffixes."""
    for cut in (sample_name, sample_name.rsplit("_", 1)[0]):
        fam = families.get(cut)
        if fam is None:
            continue
        suffix = sample_name[len(cut):]
        if suffix in _SUFFIXES.get(fam.type, ("",)):
            return fam
    return None


def _check_histogram(fam: Family) -> None:
    by_key: dict[tuple, list[Sample]] = {}
    for s in fam.samples:
        if s.name == fam.name + "_bucket":
            key = tuple(sorted((k, v) for k, v in s.labels.items()
                               if k != "le"))
            by_key.setdefault(key, []).append(s)
    sums = fam.series("_sum")
    counts = fam.series("_count")
    for key, buckets in by_key.items():
        def le(s):
            v = s.labels.get("le")
            if v is None:
                raise ValueError(f"line {s.line}: _bucket without le label")
            return math.inf if v == "+Inf" else float(v)
        ordered = sorted(buckets, key=le)
        values = [b.value for b in ordered]
        if values != sorted(values):
            raise ValueError(
                f"{fam.name}: buckets not cumulative for labels {key}")
        if le(ordered[-1]) != math.inf:
            raise ValueError(f"{fam.name}: no +Inf bucket for labels {key}")
        if key not in counts or key not in sums:
            raise ValueError(
                f"{fam.name}: missing _sum/_count for labels {key}")
        if values[-1] != counts[key]:
            raise ValueError(
                f"{fam.name}: +Inf bucket {values[-1]} != _count "
                f"{counts[key]} for labels {key}")


def _check_summary(fam: Family) -> None:
    for s in fam.samples:
        if s.name == fam.name:
            q = s.labels.get("quantile")
            if q is None:
                raise ValueError(
                    f"line {s.line}: summary sample without quantile label")
            qf = float(q)
            if not 0.0 <= qf <= 1.0:
                raise ValueError(
                    f"line {s.line}: quantile {q} outside [0, 1]")


def parse(text: str) -> dict[str, Family]:
    """Parse + validate one exposition; raises ValueError on violations."""
    families: dict[str, Family] = {}
    pending_help: tuple[str, str] | None = None
    current: Family | None = None
    closed: set[str] = set()                 # families whose block ended
    for line_no, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            name, help_text = parts[0], parts[1] if len(parts) > 1 else ""
            if name in families:
                raise ValueError(f"line {line_no}: duplicate HELP {name}")
            if pending_help is not None:
                raise ValueError(
                    f"line {line_no}: HELP {name} before TYPE "
                    f"{pending_help[0]}")
            pending_help = (name, help_text)
        elif line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2:
                raise ValueError(f"line {line_no}: malformed TYPE line")
            name, kind = parts
            if pending_help is None or pending_help[0] != name:
                raise ValueError(
                    f"line {line_no}: TYPE {name} without preceding HELP")
            if kind not in _SUFFIXES:
                raise ValueError(f"line {line_no}: unknown type {kind!r}")
            if current is not None:
                closed.add(current.name)
            current = Family(name=name, help=pending_help[1], type=kind)
            families[name] = current
            pending_help = None
        elif line.startswith("#"):
            continue                         # plain comment
        else:
            sample = _parse_sample(line, line_no)
            fam = _family_of(sample.name, families)
            if fam is None:
                raise ValueError(
                    f"line {line_no}: sample {sample.name!r} has no "
                    f"preceding HELP/TYPE declaration")
            if fam.name in closed:
                raise ValueError(
                    f"line {line_no}: sample {sample.name!r} after family "
                    f"{fam.name} block ended (interleaved families)")
            if fam is not current:
                raise ValueError(
                    f"line {line_no}: sample {sample.name!r} outside its "
                    f"family's contiguous block")
            fam.samples.append(sample)
    if pending_help is not None:
        raise ValueError(f"dangling HELP {pending_help[0]} without TYPE")
    for fam in families.values():
        if fam.type == "histogram":
            _check_histogram(fam)
        elif fam.type == "summary":
            _check_summary(fam)
    return families
