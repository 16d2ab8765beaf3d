"""End-to-end transaction applications (paper §10.2): SmallBank and TATP."""

from .smallbank import SmallBank
from .tatp import TATP

__all__ = ["SmallBank", "TATP"]
