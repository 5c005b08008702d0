"""Decoders of the port (`mergenet_tpu.decoder` is the reference)."""

from .segmenter import ObjectSegmenter, SegmenterOptions

__all__ = ["ObjectSegmenter", "SegmenterOptions"]
