"""Atomic, checksummed checkpoints on `repro`'s on-disk format
(`checkpointer`)."""
