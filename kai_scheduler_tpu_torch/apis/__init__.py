"""CRD-equivalent API objects (the port's copy; see ``types``)."""
