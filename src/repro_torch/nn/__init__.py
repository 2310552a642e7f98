"""Core modules of the port: Linear (dense), LayerNorm, ResMLP."""
