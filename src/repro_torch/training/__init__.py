"""Scoring and serving steps of the LM stack (port of ``repro/training``);
training waits for its slice (ROADMAP A12)."""
