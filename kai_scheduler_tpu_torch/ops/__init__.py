"""The solver operations of one allocate cycle — DRF division, predicate
masks, scoring, ordering and the allocate wavefront — with the four
hand-written CUDA kernels behind their wrappers (see :mod:`..kernels`)."""
