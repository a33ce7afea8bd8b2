"""Port of ``repro/data``: the deterministic synthetic LM batches."""
