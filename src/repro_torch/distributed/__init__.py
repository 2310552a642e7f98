"""Multi-process execution of the port (counterpart of ``repro/distributed``):
process groups, meshes and collectives in ``compat``, the sequence layout in
``sharding``. Gradient compression is not ported."""
