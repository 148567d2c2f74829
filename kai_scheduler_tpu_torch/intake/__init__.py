"""Intake: the journal's write choke point (``gate``)."""
