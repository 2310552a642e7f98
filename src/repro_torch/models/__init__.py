"""Models of the port: the FLARE PDE surrogate and the model API."""
