"""Shared serving-config bases.

The deadline lives in ONE base (`DeadlineConfig`) that every server config
extends, so they agree on its meaning.  The `TwinService` protocol and the
fleet-topology config wait for the sharded and federated servers.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["DeadlineConfig"]


@dataclass(frozen=True, kw_only=True)
class DeadlineConfig:
    """The mission refresh budget, declared once.  `deadline_s` is SECONDS;
    the 1.0 s default is the paper's margin — 5x under the 5 s human-pilot
    reaction time."""
    deadline_s: float = 1.0
