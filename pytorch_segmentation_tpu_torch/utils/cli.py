"""What the port's command lines share: the ROADMAP item that each flag
whose machinery is not ported yet waits for, and the refusal of such a flag
(argparse's error: exit status 2, the item named)."""

from __future__ import annotations

import argparse

from ..models import apply_scan_blocks, variant_kwargs
from .roadmap import ROADMAP_ITEMS, not_ported

__all__ = ["ROADMAP_ITEMS", "unported_options", "refuse_unported"]


def unported_options(values: dict, table: dict) -> list[str]:
    """table: option name -> (default, ROADMAP item number). One message
    for each option of `values` set away from its default."""
    return [str(not_ported(f"--{name.replace('_', '-')}", item))
            for name, (default, item) in table.items()
            if values.get(name, default) != default]


def refuse_unported(parser: argparse.ArgumentParser,
                    opt: argparse.Namespace, table: dict) -> None:
    """Exit through `parser.error` (status 2) if `opt` sets an option of
    `table`, names a `--variant` that its family lacks, or sets
    `--scan-blocks` for a family other than segformer."""
    problems = unported_options(vars(opt), table)
    model = getattr(opt, "model", None)
    variant = getattr(opt, "variant", "")
    if model is not None and variant:
        try:
            variant_kwargs(model, variant)
        except ValueError as e:
            problems.append(str(e))
    if model is not None and getattr(opt, "scan_blocks", False):
        try:
            apply_scan_blocks(model, {}, True)
        except SystemExit as e:
            problems.append(str(e))
    if problems:
        parser.error("; ".join(problems))
