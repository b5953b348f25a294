"""APSD mode constants and the paper's mode-switch rule (the part of
repro/core/apsd.py the request lifecycle uses)."""
from __future__ import annotations

__all__ = ["NONPAR", "PAR", "APSDPolicy"]

NONPAR = 0
PAR = 1


class APSDPolicy:
    """The paper's mode-switch rule, isolated for reuse."""

    @staticmethod
    def next_mode(mode: int, all_accepted: bool, first_match: bool) -> int:
        if mode == NONPAR:
            # a fully-accepted short window is evidence drafting is easy
            return PAR if all_accepted else NONPAR
        return PAR if (all_accepted and first_match) else NONPAR
