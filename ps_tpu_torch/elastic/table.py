"""The versioned shard table: which shard serves each parameter key.

Counterpart of ``ps_tpu/elastic/table.py``, the same code and the same
wire dict. A static deployment fixes the key-to-server map at boot
(``shard_for_key`` over the URI list every process was started with);
under a coordinator the map is explicit and versioned: ``shards`` lists
the members (each a replica-set URI, ``"h:p"`` or ``"h:p|b:q"``),
``assign`` maps every key to a shard index, and ``epoch`` advances once
per committed change (a join that brings keys, a move, a drain). A worker
refused with a higher table epoch re-fetches the table and re-routes, so
the epoch is the fencing token of the assignment.

The first table describes what the servers booted with (they register
their key ranges); every later change is planned here
(:func:`plan_moves`) and driven by the coordinator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class ShardTable:
    """One snapshot of the key-to-shard assignment.

    :meth:`to_wire`/:meth:`from_wire` give the plain json dict that rides
    a frame's ``extra``. A change replaces the whole object (never an
    update in place), so a reader always sees one epoch with its own
    assignment.
    """

    def __init__(self, epoch: int, shards: Sequence[str],
                 assign: Dict[str, int]):
        self.epoch = int(epoch)
        self.shards = list(shards)
        self.assign = dict(assign)
        for k, s in self.assign.items():
            if not (0 <= int(s) < len(self.shards)):
                raise ValueError(
                    f"table assigns key {k!r} to shard {s} but only "
                    f"{len(self.shards)} shard(s) are registered")

    def to_wire(self) -> dict:
        return {"epoch": self.epoch, "shards": list(self.shards),
                "assign": dict(self.assign)}

    @classmethod
    def from_wire(cls, d: dict) -> "ShardTable":
        return cls(int(d["epoch"]), list(d["shards"]),
                   {k: int(v) for k, v in d["assign"].items()})

    def keys_of(self, shard: int) -> List[str]:
        return sorted(k for k, s in self.assign.items() if s == int(shard))

    def owner_map(self) -> Dict[str, int]:
        return dict(self.assign)

    def addrs(self) -> List[Tuple[str, int]]:
        """Each shard's preferred (primary) address, what a worker dials."""
        from ps_tpu_torch.backends.common import parse_replica_uri

        primaries, _ = parse_replica_uri(",".join(self.shards))
        return primaries

    def replica_sets(self) -> List[List[Tuple[str, int]]]:
        from ps_tpu_torch.backends.common import parse_replica_uri

        _, sets = parse_replica_uri(",".join(self.shards))
        return sets

    def covers(self, keys) -> bool:
        """Every key of ``keys`` is assigned: what a joining worker waits
        for while the servers register."""
        return all(k in self.assign for k in keys)

    def __repr__(self) -> str:
        per = [sum(1 for s in self.assign.values() if s == i)
               for i in range(len(self.shards))]
        return (f"ShardTable(epoch={self.epoch}, shards={len(self.shards)}, "
                f"keys/shard={per})")


#: one planned move: (donor shard index, recipient shard index, keys)
Move = Tuple[int, int, List[str]]


def plan_moves(key_bytes: Dict[str, int], assign: Dict[str, int],
               targets: Sequence[int],
               max_moves: Optional[int] = None) -> List[Move]:
    """Moves that level the bytes over ``targets`` while moving little.

    ``key_bytes`` sizes each key, ``assign`` is the current map and
    ``targets`` the shards that serve afterwards: a shard of ``assign``
    outside ``targets`` is drained, every key of it moves. Greedy: the
    drained keys first, largest first onto the lightest target; then a
    key at a time from the heaviest shard to the lightest, largest first,
    while that strictly narrows the gap. Ties break by key name, so the
    same inputs always give the same plan.
    """
    targets = sorted(set(int(t) for t in targets))
    if not targets:
        raise ValueError("plan_moves needs at least one target shard")
    load: Dict[int, int] = {t: 0 for t in targets}
    homeless: List[str] = []  # keys of drained shards
    for k, s in assign.items():
        if s in load:
            load[s] += key_bytes.get(k, 0)
        else:
            homeless.append(k)
    moves: Dict[Tuple[int, int], List[str]] = {}

    def lightest() -> int:
        return min(targets, key=lambda t: (load[t], t))

    for k in sorted(homeless, key=lambda k: (-key_bytes.get(k, 0), k)):
        t = lightest()
        moves.setdefault((assign[k], t), []).append(k)
        load[t] += key_bytes.get(k, 0)
    if len(targets) > 1:
        by_shard: Dict[int, List[str]] = {t: [] for t in targets}
        for k, s in assign.items():
            if s in by_shard:
                by_shard[s].append(k)
        for s in by_shard:
            by_shard[s].sort(key=lambda k: (-key_bytes.get(k, 0), k))
        budget = max_moves if max_moves is not None else len(assign)
        n = 0
        while n < budget:
            hi = max(targets, key=lambda t: (load[t], -t))
            lo = lightest()
            gap = load[hi] - load[lo]
            moved = False
            for i, k in enumerate(by_shard[hi]):
                b = key_bytes.get(k, 0)
                # the move leaves a gap of |gap - 2b|
                if abs(gap - 2 * b) < gap:
                    moves.setdefault((hi, lo), []).append(k)
                    load[hi] -= b
                    load[lo] += b
                    del by_shard[hi][i]
                    by_shard[lo].append(k)
                    moved = True
                    n += 1
                    break
            if not moved:
                break
    return [(d, r, sorted(ks)) for (d, r), ks in sorted(moves.items())]


def skew(loads: Dict[int, int]) -> float:
    """The largest byte load over the smallest (inf when one shard is
    empty and another is not; 1 for no load): what an automatic
    rebalance compares with ``rebalance_max_skew``."""
    vals = list(loads.values())
    if not vals or max(vals) == 0:
        return 1.0
    lo = min(vals)
    if lo == 0:
        return float("inf")
    return max(vals) / lo
