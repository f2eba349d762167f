"""
SARIF 2.1.0 output of the port's analyzers: one run per document, the
rule set as the driver's rule metadata and each finding as an ``error``
result, in the shape of the JAX package's writer (``tools/riplint.py``'s
``_sarif_doc``), so both packages' results merge in one upload. Used by
``apps/rprove.py`` and ``apps/ripsched.py``; the AST rules take it up
when they join the port.
"""
__all__ = ["SARIF_SCHEMA", "sarif_doc"]

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def sarif_doc(findings, rules, tool, stale=()):
    """One SARIF run of ``tool``. ``rules`` is a sequence of (id, name,
    description); ``findings`` are dicts with ``path``, ``line``,
    ``col``, ``rule`` and ``message``; ``stale`` (baseline entries whose
    code is gone: ``path``, ``rule``, ``line_text``) become results
    too."""
    results = [_result(f["rule"], f["message"], f["path"],
                       max(1, f["line"]), f["col"] + 1) for f in findings]
    results += [_result(
        e["rule"],
        f"STALE baseline entry (line_text={e['line_text']!r}) — the code "
        "it justified is gone; delete the entry or run --update-baseline",
        e["path"], 1, 1) for e in stale]
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": tool,
                "rules": [{"id": rid, "name": name,
                           "shortDescription": {"text": desc or name}}
                          for rid, name, desc in rules],
            }},
            "results": results,
        }],
    }


def _result(rule, message, path, line, col):
    return {
        "ruleId": rule,
        "level": "error",
        "message": {"text": message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": path},
                "region": {"startLine": line, "startColumn": col},
            },
        }],
    }
