"""Prometheus text exposition (counterpart of ``dcnn_tpu/obs/exposition.py``):
the one place label and escape rules live.

:meth:`MetricsRegistry.prometheus` and :meth:`ServeMetrics.prometheus`
both render through these helpers, and for the same instruments the text
is byte for byte the JAX package's:

- ``# HELP`` / ``# TYPE`` header lines precede each series, HELP text
  with backslash and newline escaped;
- counters are cumulative and named ``*_total``;
- histograms emit cumulative ``_bucket{le="..."}`` series ending with
  ``le="+Inf"``, plus ``_sum`` / ``_count``, whose ``_count`` equals the
  ``+Inf`` bucket.

:func:`parse_prometheus_text` is the inverse, so an in-repo consumer (the
tsdb sampler, a scrape client) reads the same text an external scraper
would. Standard library only.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def escape_help(text: str) -> str:
    """HELP-line escaping per the exposition spec: backslash and newline."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    """Label-value escaping: backslash, double-quote, newline."""
    return (text.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def format_value(v) -> str:
    """One numeric formatting rule for every series: ``repr`` keeps ints
    exact and floats round-trippable (what both emitters always used)."""
    return repr(v)


def render_header(name: str, kind: str, help: str = "") -> List[str]:
    """``# HELP`` (when non-empty) + ``# TYPE`` lines for one series."""
    lines = []
    if help:
        lines.append(f"# HELP {name} {escape_help(help)}")
    lines.append(f"# TYPE {name} {kind}")
    return lines


def render_scalar(name: str, kind: str, value, help: str = "") -> List[str]:
    """A complete single-sample series (counter or gauge)."""
    return render_header(name, kind, help) + [
        f"{name} {format_value(value)}"]


def render_histogram(name: str, cumulative: Iterable[Tuple[float, int]],
                     sum_: float, count: int, help: str = "") -> List[str]:
    """A complete histogram family from ``(upper_bound, cumulative_count)``
    pairs (the last pair must be the ``+Inf`` bucket — callers hand us
    :meth:`Histogram.cumulative` output, which guarantees it)."""
    lines = render_header(name, "histogram", help)
    for le, cum in cumulative:
        le_s = "+Inf" if le == float("inf") else repr(le)
        lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
    lines.append(f"{name}_sum {format_value(sum_)}")
    lines.append(f"{name}_count {count}")
    return lines


def unescape_help(text: str) -> str:
    """Inverse of :func:`escape_help` — a left-to-right scan, because
    ordered ``str.replace`` calls corrupt a literal backslash followed
    by ``n`` (``\\\\n`` must decode to ``\\`` + ``n``, not a newline)."""
    out, i = [], 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            out.append({"\\": "\\", "n": "\n"}.get(nxt, text[i:i + 2]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def unescape_label_value(text: str) -> str:
    """Inverse of :func:`escape_label_value`."""
    out, i = [], 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            nxt = text[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(body: str) -> Dict[str, str]:
    """``key="value",...`` (the content between ``{`` and ``}``) → dict,
    honoring escaped quotes/backslashes inside values."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.index("=", i)
        key = body[i:eq].strip()
        j = body.index('"', eq) + 1
        val = []
        while j < n:
            c = body[j]
            if c == "\\" and j + 1 < n:
                val.append(body[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            val.append(c)
            j += 1
        labels[key] = unescape_label_value("".join(val))
        i = j + 1
        while i < n and body[i] in ", ":
            i += 1
    return labels


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Parse exposition text back into metric families: the inverse of
    the renderers above, so a scrape client's only contract with a
    process is the text an external scraper reads.

    Returns ``{family_name: {"kind", "help", "samples", ...}}`` where
    ``samples`` is a list of ``(labels_dict, value)`` pairs. Scalar
    families (one unlabeled sample) additionally carry ``"value"``;
    histogram families carry ``"buckets"`` (``(upper_bound,
    cumulative_count)`` pairs, ``+Inf`` last), ``"sum"`` and ``"count"``
    — the exact shape :func:`render_histogram` consumed, so
    render(parse(render(x))) is the identity on values. Unknown series
    (no ``# TYPE``) parse with kind ``"untyped"``. Malformed lines raise
    ``ValueError``: a scrape that half-parses must not feed a decision."""
    families: Dict[str, Dict[str, Any]] = {}

    def family(name: str) -> Dict[str, Any]:
        return families.setdefault(name, {
            "kind": "untyped", "help": "", "samples": []})

    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                family(parts[2])["kind"] = parts[3] if len(parts) > 3 \
                    else "untyped"
            elif len(parts) >= 3 and parts[1] == "HELP":
                family(parts[2])["help"] = unescape_help(
                    parts[3] if len(parts) > 3 else "")
            continue  # other comments are legal and ignored
        try:
            if "{" in line:
                name = line[:line.index("{")]
                rest = line[line.index("{") + 1:]
                labels = _parse_labels(rest[:rest.rindex("}")])
                value = _parse_value(rest[rest.rindex("}") + 1:].split()[0])
            else:
                name, val_s = line.split(None, 1)
                labels = {}
                value = _parse_value(val_s.split()[0])
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"unparseable exposition line {lineno}: {line!r}") from e
        # histogram child series fold into their family
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            cand = name[:-len(suffix)] if name.endswith(suffix) else None
            if cand and cand in families \
                    and families[cand]["kind"] == "histogram":
                base = cand
                break
        if base is not None:
            fam = families[base]
            if name.endswith("_bucket"):
                fam.setdefault("buckets", []).append(
                    (_parse_value(labels.get("le", "+Inf")), int(value)))
            elif name.endswith("_sum"):
                fam["sum"] = value
            else:
                fam["count"] = int(value)
            fam["samples"].append((labels, value))
        else:
            fam = family(name)
            fam["samples"].append((labels, value))
            if not labels:
                fam["value"] = value
    return families


def scalar_values(families: Dict[str, Dict[str, Any]]
                  ) -> Dict[str, float]:
    """Flatten parsed families to ``{name: value}`` for every scalar
    (unlabeled single-sample) series."""
    return {name: fam["value"] for name, fam in families.items()
            if "value" in fam}


def render_instruments(items) -> List[str]:
    """Exposition lines for ``(name, instrument)`` pairs of the registry's
    Counter / Gauge / Histogram kinds (import deferred — registry imports
    this module)."""
    from .registry import Counter, Histogram

    lines: List[str] = []
    for name, inst in items:
        if isinstance(inst, Histogram):
            v = inst.value
            lines.extend(render_histogram(name, inst.cumulative(),
                                          v["sum"], v["count"], inst.help))
        else:
            kind = "counter" if isinstance(inst, Counter) else "gauge"
            lines.extend(render_scalar(name, kind, inst.value, inst.help))
    return lines
