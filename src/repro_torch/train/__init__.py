"""The training step (`step`)."""
