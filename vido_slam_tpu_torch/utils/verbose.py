"""Leveled logging — the reference's Verbose class (vido_slam/include/
System.h:25-50) with the same five levels."""

from __future__ import annotations

import sys
from enum import IntEnum


class VerbosityLevel(IntEnum):
    VERBOSITY_QUIET = 0
    VERBOSITY_NORMAL = 1
    VERBOSITY_VERBOSE = 2
    VERBOSITY_VERY_VERBOSE = 3
    VERBOSITY_DEBUG = 4


class Verbose:
    th = VerbosityLevel.VERBOSITY_NORMAL

    @staticmethod
    def set_th(level: VerbosityLevel) -> None:
        Verbose.th = level

    @staticmethod
    def print_mess(msg: str, level: VerbosityLevel = VerbosityLevel.VERBOSITY_NORMAL) -> None:
        if level <= Verbose.th:
            print(msg, file=sys.stderr)
