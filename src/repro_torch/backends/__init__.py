"""Mixer backends: importing this package fills the registry in
:mod:`repro_torch.core.dispatch`. The names match the JAX package's, so a
policy spelled for it resolves to the counterpart here."""
from repro_torch.backends import (  # noqa: F401  (import for registration side effect)
    causal,
    materialized,
    packed,
    packed_shard,
    paged,
    pallas,
    sdpa,
    seqparallel,
)
