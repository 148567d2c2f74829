"""Resource-reservation registry — the reservation-pod lifecycle.

Port of ``kai_scheduler_tpu/runtime/reservation.py``.  For every shared
accelerator the reference's binder keeps a reservation pod; here the
reservation is a registry entry keyed by (node, device) that carries the
stable identifier sharers mount and the set of fractional pods sharing the
device.  The binder's gpusharing plugin acquires and releases entries, and
``Cluster.tick`` releases a deleted pod's entries; an entry dies with its
last sharer.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Reservation:
    """One shared accelerator — ref the per-GPU-group reservation pod."""

    node: str
    device: int
    #: stable runtime identifier sharers mount (NVML UUID analogue)
    uuid: str
    #: fractional pods sharing the device
    owners: set = dataclasses.field(default_factory=set)


class ReservationRegistry:
    """Share-group bookkeeping keyed by (node, device)."""

    def __init__(self):
        self._by_group: dict[tuple[str, int], Reservation] = {}

    def acquire(self, node: str, device: int, pod_name: str) -> Reservation:
        """Join (creating if needed) the reservation for a device —
        the binder's ``reserveGPUs`` + wait-for-UUID step collapsed:
        identity is synthesized deterministically instead of being
        discovered by an agent process."""
        key = (node, device)
        res = self._by_group.get(key)
        if res is None:
            res = Reservation(node=node, device=device,
                              uuid=f"accel://{node}/{device}")
            self._by_group[key] = res
        res.owners.add(pod_name)
        return res

    def release(self, pod_name: str, node: str | None = None,
                device: int | None = None) -> None:
        """Drop a sharer; the reservation dies with its last owner (ref
        the binder deleting the reservation pod when the group empties).
        ``node`` alone sweeps every group of the pod on that node;
        neither sweeps all of the pod's groups — the pod-deletion path.
        """
        for key, res in list(self._by_group.items()):
            if node is not None and key[0] != node:
                continue
            if device is not None and key[1] != device:
                continue
            res.owners.discard(pod_name)
            if not res.owners:
                del self._by_group[key]

    def get(self, node: str, device: int) -> Reservation | None:
        return self._by_group.get((node, device))

    def for_pod(self, pod_name: str) -> list[Reservation]:
        return [r for r in self._by_group.values()
                if pod_name in r.owners]

    def __len__(self) -> int:
        return len(self._by_group)
