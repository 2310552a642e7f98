"""The FLARE operator, its backend registry and the mixer policy."""
