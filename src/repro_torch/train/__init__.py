"""The training step (`step`), data-parallel over a mesh of ranks, and
the GPipe pipeline over a stage axis (`pipeline`)."""
