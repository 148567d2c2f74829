"""The solver operations of one cycle — DRF division, predicate masks,
scoring, ordering, the allocate wavefront, the victim scenario engine and
stale-gang eviction — with the hand-written CUDA kernels behind their
wrappers (see :mod:`..kernels`)."""
