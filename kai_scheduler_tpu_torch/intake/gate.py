"""The mutation gate — the journal's write choke point.

Port of the hub-mutator half of ``kai_scheduler_tpu/intake/gate.py``:
every write into a cluster's
:class:`~..state.incremental.MutationJournal` outside the journal's own
module flows through these helpers — the hub's own mutators
(``runtime/cluster.py``) and the binder's commit write-backs.  One choke
point keeps the mapping from object mutations to mark kinds in one
place.  The helpers are thin pass-throughs: the journal's locking and
cursor fan-out live with the journal (``state/incremental.py``).

The upsert/delete mappings of delta documents wait for the intake slice.
Dependency-free, so ``runtime/cluster.py`` imports it without cycles.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..state.incremental import MutationJournal


def pod_touched(journal: "MutationJournal", name: str) -> None:
    journal.mark_pod(name)


def pod_added(journal: "MutationJournal", name: str) -> None:
    journal.mark_pod_added(name)


def pod_removed(journal: "MutationJournal", name: str) -> None:
    journal.mark_pod_removed(name)


def gang_touched(journal: "MutationJournal", name: str) -> None:
    journal.mark_gang(name)


def gang_added(journal: "MutationJournal", name: str) -> None:
    journal.mark_gang_added(name)


def node_touched(journal: "MutationJournal", name: str) -> None:
    journal.mark_node(name)


def structural(journal: "MutationJournal", reason: str) -> None:
    journal.mark_structural(reason)


def time_advanced(journal: "MutationJournal") -> None:
    journal.mark_time()


def merge_marks(journal: "MutationJournal", marks) -> None:
    """Bulk-replay an ordered ``(kind, name)`` mark batch under one lock
    acquisition (``MutationJournal.merge``)."""
    journal.merge(marks)
