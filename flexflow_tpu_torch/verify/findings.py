"""Finding records + the exemption-file policy for the verifier
(PyTorch port of ``flexflow_tpu/verify/findings.py``).

A finding's identity (``pass:code:where``) is line-number-free so
exemptions survive unrelated edits; the message carries the line.  Every
exemption MUST carry a non-empty reason string — the same policy
``tools/check_flag_forwarding.py`` applies to its CNN_ONLY table — and
an exemption that matches nothing is itself an error (stale exemptions
rot into blanket ones).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    pass_name: str      # "plan" (the passes ported so far)
    code: str           # e.g. "device_get", "non_donated", "host_callback"
    severity: str       # error | warning | info
    where: str          # stable locus, e.g. "model.py:_fit:device_get"
    message: str        # human detail (line numbers, sizes, seconds)
    exempted: bool = False
    reason: str = ""    # the exemption's reason when exempted

    def ident(self) -> str:
        return f"{self.pass_name}:{self.code}:{self.where}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_exemptions(path: str) -> Dict[str, str]:
    """``{ident: reason}`` from an exemption file.  Format::

        {"exemptions": [{"id": "sync:device_get:model.py:_fit",
                         "reason": "loss fetch at the log boundary"}]}

    Every entry needs a non-empty ``reason`` — a reasonless exemption is
    a config error, not a quieter finding."""
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, str] = {}
    for e in data.get("exemptions", []):
        ident, reason = e.get("id", ""), str(e.get("reason", "")).strip()
        if not ident:
            raise ValueError(f"exemption without an id: {e!r}")
        if not reason:
            raise ValueError(
                f"exemption {ident!r} has no reason string — every "
                f"exemption must say WHY it is approved")
        if ident in out:
            raise ValueError(f"duplicate exemption {ident!r}")
        out[ident] = reason
    return out


def apply_exemptions(findings: List[Finding],
                     exemptions: Dict[str, str]) -> Tuple[List[Finding],
                                                          List[str]]:
    """Mark exempted findings in place; return (findings, unused_ids).
    An id ending in ``*`` prefix-matches (one exemption for a family of
    loci); unused exemptions are reported so they get pruned."""
    used = set()
    for f in findings:
        ident = f.ident()
        reason = exemptions.get(ident)
        matched = ident if reason is not None else None
        if reason is None:
            for eid, r in exemptions.items():
                if eid.endswith("*") and ident.startswith(eid[:-1]):
                    reason, matched = r, eid
                    break
        if reason is not None:
            f.exempted, f.reason = True, reason
            used.add(matched)
    unused = sorted(set(exemptions) - used)
    return findings, unused


def counts(findings: List[Finding]) -> dict:
    """Severity tally of NON-exempt findings plus the exempted count."""
    out = {"error": 0, "warning": 0, "info": 0, "exempted": 0}
    for f in findings:
        if f.exempted:
            out["exempted"] += 1
        else:
            out[f.severity] += 1
    return out
