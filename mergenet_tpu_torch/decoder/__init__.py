"""Decoders of the port (`mergenet_tpu.decoder` is the reference)."""
