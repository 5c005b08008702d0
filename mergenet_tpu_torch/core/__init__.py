"""Core invariants of the port (`mergenet_tpu.core` is the reference)."""

from .offsets import generate_offsets, validate_offsets
from .config import CoreConfig

__all__ = ["generate_offsets", "validate_offsets", "CoreConfig"]
