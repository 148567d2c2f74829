"""Host-side runtime: the in-memory cluster document store."""
