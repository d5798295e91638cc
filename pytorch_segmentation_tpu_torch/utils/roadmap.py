"""The ROADMAP items that the port's unported options and code paths wait
for, and the refusal that names one. Imports nothing of the package, so
that any module can raise it."""

from __future__ import annotations

__all__ = ["ROADMAP_ITEMS", "not_ported"]

# ROADMAP.md queue 1, by item number
ROADMAP_ITEMS = {
    10: "ROADMAP queue 1 item 10, --spatial, tp, pp, ep and nn/moe.py",
    11: "ROADMAP queue 1 item 11, export and utilities",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error to raise for `what` (an option or a code path) whose
    machinery waits for ROADMAP queue 1 item `item`."""
    return NotImplementedError(f"{what} is not ported yet "
                               f"({ROADMAP_ITEMS[item]})")
