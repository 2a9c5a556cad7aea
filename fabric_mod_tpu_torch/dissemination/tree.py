"""RelayTree: the dissemination tree as a pure function.

The port's copy of fabric_mod_tpu/dissemination/tree.py.  Every peer
computes the tree from three inputs — the alive membership, the elected
leader and an epoch — so all peers with a converged membership view
derive the same tree with no coordination message (the trick the
deterministic min-PKI-ID election plays for leadership: agreement from
a shared view and a shared pure function; reference:
gossip/election/election.go).

Layout: the BFS array ``[leader] + rotate(sorted(others), epoch)`` with
fan-out degree d — the member at index i parents indices
``d*i+1 .. d*i+d``.  The epoch rotation re-deals interior positions
across epochs, so relay load does not pin to the smallest endpoints.

Reparenting is the same function over the shrunken membership:
``tree.without(dead)`` is what every survivor computes when discovery
expires a member, and :func:`reparent_plan` names the members that
moved.  A dead leader is the election's job: `without` roots the new
tree at the survivors' minimum, what the election converges to.  The
degree is a constructor argument (the reference's
FABRIC_MOD_TPU_RELAY_DEGREE, default 4).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# the reference's FABRIC_MOD_TPU_RELAY_DEGREE default
DEGREE = 4


class RelayTree:
    """One channel's relay tree over orderable member ids (gossip
    endpoints)."""

    __slots__ = ("leader", "epoch", "degree", "order", "_index")

    def __init__(self, members: Iterable[str], leader: str,
                 epoch: int = 0, degree: int = DEGREE):
        self.degree = max(1, int(degree))
        self.leader = leader
        self.epoch = int(epoch)
        others = sorted(mm for mm in set(members) if mm != leader)
        if others:
            r = self.epoch % len(others)
            others = others[r:] + others[:r]
        self.order: Tuple[str, ...] = (leader, *others)
        self._index: Dict[str, int] = {mm: i for i, mm
                                       in enumerate(self.order)}

    # -- pure queries -----------------------------------------------------
    def __contains__(self, member: str) -> bool:
        return member in self._index

    def __len__(self) -> int:
        return len(self.order)

    def children(self, member: str) -> List[str]:
        """The members `member` pushes frames to ([] for leaves and for
        members outside the tree: a peer whose view has not converged
        relays to nobody rather than guessing)."""
        i = self._index.get(member)
        if i is None:
            return []
        lo = i * self.degree + 1
        return list(self.order[lo:lo + self.degree])

    def parent(self, member: str) -> Optional[str]:
        i = self._index.get(member)
        if i is None or i == 0:
            return None
        return self.order[(i - 1) // self.degree]

    def depth(self, member: str) -> int:
        """Hops from the leader (-1 for a non-member)."""
        i = self._index.get(member)
        if i is None:
            return -1
        d = 0
        while i > 0:
            i = (i - 1) // self.degree
            d += 1
        return d

    # -- reparenting ------------------------------------------------------
    def without(self, dead: str) -> "RelayTree":
        """The tree every survivor derives once `dead` expires from the
        membership view: the same leader, epoch and degree, unless the
        leader itself died, when the survivors' minimum roots it."""
        members = [mm for mm in self.order if mm != dead]
        leader = self.leader
        if dead == leader:
            leader = min(members) if members else ""
        return RelayTree(members, leader, epoch=self.epoch,
                         degree=self.degree)


def reparent_plan(old: RelayTree,
                  new: RelayTree) -> Dict[str, Tuple[Optional[str],
                                                     Optional[str]]]:
    """member -> (old_parent, new_parent) for every member present in
    both trees whose parent changed: the peers that start taking frames
    from a new upstream after a membership change (bookkeeping only:
    frames are self-describing and commits are gated by the state
    buffer either way)."""
    plan: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
    for member in new.order:
        if member not in old:
            continue
        was, now = old.parent(member), new.parent(member)
        if was != now:
            plan[member] = (was, now)
    return plan
