"""The verdict of a run: every number compared against its limit."""

from __future__ import annotations


def judge(rec: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when the run served
    something, failed nothing, and every compared number is at or under
    its limit (a number the run could not give fails)."""
    checks = {name: {"value": rec["checks"].get(name), "limit": limit}
              for name, limit in limits["limits"].items()}
    ok = (rec["failed"] == 0 and rec["attempted"] > 0
          and all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values()))
    return ok, checks
