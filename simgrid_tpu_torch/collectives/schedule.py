"""Static communication schedules: the comm-DAG IR behind the tapes.

The port's own copy of ``simgrid_tpu/collectives/schedule.py`` (it never
imports the reference); the schedules, record ids and edge lists must
be the reference's exactly.

A *schedule* is, per rank, the ordered list of point-to-point
operations a collective algorithm posts — the exact information the
SMPI maestro discovers one mailbox match at a time.  Compiling it
ahead of time is what lets the superstep while_loop walk the whole
collective on device (ASTRA-sim 3.0's workload-layer move): each
matched (send, recv) pair becomes ONE comm record with an explicit
predecessor set, and ops/lmm_drain's collective tape fires successor
records by indexed scatter instead of a host round trip per step.

Per-rank programs use four op shapes (blocking send/recv are emitted
as post + wait, mirroring smpi.Comm where ``send`` is Request.start()
+ wait() and ``sendrecv`` decomposes as irecv, isend, wait(recv),
wait(send)):

    ("isend", dst, tag, size, h)   ("irecv", src, tag, h)   ("wait", h)

``h`` is a per-rank handle (the post's sequence number).  Matching
follows the non-overtaking rule: per (src, dst, tag) channel, the
i-th recv posted matches the i-th send posted — the same FIFO
sequencing smpi.runtime applies to its mailboxes, and the reason one
constant tag per collective is safe (see coll.allreduce_lr's note).

Dependency construction is a per-rank *frontier* walk: a record's
predecessors are every record whose completion the posting rank (and
the receiving rank, at its own post point) had already waited on.  On
``wait`` the frontier becomes ``(frontier - rec.preds) | {rec}`` —
records implied transitively through the awaited record are pruned,
keeping the edge list near-minimal without changing reachability.

The ``seq_*`` generators below mirror smpi/coll.py's default
algorithms LINE FOR LINE (same peer formulas, same tag, same posting
order).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

# The SMPI collective tags (reference smpi/include/private.hpp
# COLL_TAG_*), kept literal.
TAG_BCAST = -10
TAG_REDUCE = -12
TAG_ALLREDUCE = -13
TAG_ALLTOALL = -14

#: payload_size() of a non-buffer python object (dict payloads in
#: bruck/rdb-allgather, scalars) — smpi/datatype.py's fallback
_OBJ_BYTES = 8.0


class CommRec:
    """One matched point-to-point transfer: the tape row's identity
    half (src, dst, size) plus its dependency set.  ``rid`` is the
    flow slot in the compiled tape; allocation is rank-major in send
    program order, so record ids are deterministic for a given
    schedule."""

    __slots__ = ("rid", "src", "dst", "tag", "size", "preds")

    def __init__(self, rid: int, src: int, dst: int, tag: int,
                 size: float):
        self.rid = rid
        self.src = src
        self.dst = dst
        self.tag = tag
        self.size = float(size)
        self.preds: set = set()

    def key(self) -> tuple:
        return (self.src, self.dst, self.tag, self.size,
                tuple(sorted(r.rid for r in self.preds)))


class Prog:
    """Per-rank op-sequence recorder (the capture shim and the direct
    generators share it, so both sides emit identical op tuples)."""

    __slots__ = ("ops", "_h")

    def __init__(self):
        self.ops: List[tuple] = []
        self._h = 0

    def isend(self, dst: int, tag: int, size: float) -> int:
        h = self._h
        self._h += 1
        self.ops.append(("isend", int(dst), int(tag), float(size), h))
        return h

    def irecv(self, src: int, tag: int) -> int:
        h = self._h
        self._h += 1
        self.ops.append(("irecv", int(src), int(tag), h))
        return h

    def wait(self, h: int) -> None:
        self.ops.append(("wait", h))

    def send(self, dst: int, tag: int, size: float) -> None:
        self.wait(self.isend(dst, tag, size))

    def recv(self, src: int, tag: int) -> None:
        self.wait(self.irecv(src, tag))

    def sendrecv(self, dst: int, src: int, size: float,
                 sendtag: int, recvtag: int) -> None:
        # mirror smpi.Comm.sendrecv: irecv first, then isend, wait the
        # recv, wait the send
        hr = self.irecv(src, recvtag)
        hs = self.isend(dst, sendtag, size)
        self.wait(hr)
        self.wait(hs)


class CollectiveSchedule:
    """A compiled schedule: the matched records (rid order) plus the
    originating per-rank programs."""

    __slots__ = ("ranks", "records", "progs")

    def __init__(self, ranks: int, records: List[CommRec],
                 progs: List[List[tuple]]):
        self.ranks = ranks
        self.records = records
        self.progs = progs

    @property
    def n_comms(self) -> int:
        return len(self.records)

    def sequence(self) -> List[tuple]:
        """(src, dst, tag, size, sorted-pred-rids) per record — the
        comparison key of the tape-vs-host parity tests."""
        return [r.key() for r in self.records]

    def edges(self) -> List[Tuple[int, int]]:
        out = []
        for rec in self.records:
            for p in sorted(r.rid for r in rec.preds):
                out.append((p, rec.rid))
        return out


def build_schedule(progs) -> CollectiveSchedule:
    """Compile per-rank programs (Prog instances or raw op lists) into
    matched records with dependency sets.

    Pass 1 allocates record ids (rank-major, send program order) and
    matches each recv against its channel's FIFO; pass 2 runs the
    per-rank frontier walk that accumulates predecessor sets.
    Unmatched ops raise — a schedule with dangling posts would
    deadlock the tape exactly like it would deadlock the maestro.
    """
    ops_per_rank = [p.ops if isinstance(p, Prog) else list(p)
                    for p in progs]
    ranks = len(ops_per_rank)
    records: List[CommRec] = []
    chan: Dict[tuple, deque] = {}
    send_rec: List[Dict[int, CommRec]] = [dict() for _ in range(ranks)]
    for r, ops in enumerate(ops_per_rank):
        for op in ops:
            if op[0] == "isend":
                _, dst, tag, size, h = op
                if not 0 <= dst < ranks:
                    raise ValueError(f"rank {r}: send to {dst} outside "
                                     f"communicator of {ranks}")
                rec = CommRec(len(records), r, dst, tag, size)
                records.append(rec)
                chan.setdefault((r, dst, tag), deque()).append(rec)
                send_rec[r][h] = rec
    recv_rec: List[Dict[int, CommRec]] = [dict() for _ in range(ranks)]
    for r, ops in enumerate(ops_per_rank):
        for op in ops:
            if op[0] == "irecv":
                _, src, tag, h = op
                q = chan.get((src, r, tag))
                if not q:
                    raise ValueError(
                        f"rank {r}: recv(src={src}, tag={tag}) has no "
                        "matching send (wildcards are not compilable)")
                recv_rec[r][h] = q.popleft()
    leftover = sum(len(chan[k]) for k in sorted(chan))
    if leftover:
        raise ValueError(f"{leftover} sends were never received")

    for r, ops in enumerate(ops_per_rank):
        frontier: set = set()
        handles = {}
        handles.update(send_rec[r])
        handles.update(recv_rec[r])
        for op in ops:
            if op[0] == "isend":
                send_rec[r][op[4]].preds |= frontier
            elif op[0] == "irecv":
                recv_rec[r][op[3]].preds |= frontier
            else:  # wait
                rec = handles.get(op[1])
                if rec is None:
                    raise ValueError(f"rank {r}: wait on unknown "
                                     f"handle {op[1]}")
                frontier = (frontier - rec.preds) | {rec}
    for rec in records:
        rec.preds.discard(rec)
    return CollectiveSchedule(ranks, records, ops_per_rank)


# ---------------------------------------------------------------------------
# direct generators — smpi/coll.py's algorithms, re-expressed as op
# emissions.  Peer formulas, tags and posting order are copied from
# the host implementations verbatim; the parity tests hold them to it.
# ---------------------------------------------------------------------------

def seq_bcast_binomial(ranks: int, nbytes: float,
                       root: int = 0) -> CollectiveSchedule:
    """coll.bcast_binomial_tree."""
    progs = [Prog() for _ in range(ranks)]
    for rank in range(ranks):
        p = progs[rank]
        relrank = (rank - root + ranks) % ranks
        mask = 1
        while mask < ranks:
            if relrank & mask:
                p.recv((rank - mask + ranks) % ranks, TAG_BCAST)
                break
            mask <<= 1
        mask >>= 1
        while mask > 0:
            if relrank + mask < ranks:
                p.send((rank + mask) % ranks, TAG_BCAST, nbytes)
            mask >>= 1
    return build_schedule(progs)


def seq_reduce_flat(ranks: int, nbytes: float,
                    root: int = 0) -> CollectiveSchedule:
    """coll.reduce_flat_ireduce (the reference default)."""
    progs = [Prog() for _ in range(ranks)]
    _emit_reduce_flat(progs, ranks, nbytes, root)
    return build_schedule(progs)


def _emit_reduce_flat(progs, ranks, nbytes, root):
    for rank in range(ranks):
        p = progs[rank]
        if rank != root:
            p.send(root, TAG_REDUCE, nbytes)
        else:
            reqs = [p.irecv(src, TAG_REDUCE) for src in range(ranks)
                    if src != root]
            for h in reqs:
                p.wait(h)


def _emit_bcast_binomial(progs, ranks, nbytes, root):
    for rank in range(ranks):
        p = progs[rank]
        relrank = (rank - root + ranks) % ranks
        mask = 1
        while mask < ranks:
            if relrank & mask:
                p.recv((rank - mask + ranks) % ranks, TAG_BCAST)
                break
            mask <<= 1
        mask >>= 1
        while mask > 0:
            if relrank + mask < ranks:
                p.send((rank + mask) % ranks, TAG_BCAST, nbytes)
            mask >>= 1


def seq_allreduce_redbcast(ranks: int, nbytes: float
                           ) -> CollectiveSchedule:
    """coll.allreduce_redbcast: reduce to 0 + bcast from 0 (the
    reference default).  Per-rank sequencing chains the two phases —
    the bcast root's sends depend on every reduce arrival."""
    progs = [Prog() for _ in range(ranks)]
    _emit_reduce_flat(progs, ranks, nbytes, 0)
    _emit_bcast_binomial(progs, ranks, nbytes, 0)
    return build_schedule(progs)


def _emit_allreduce_rdb(progs, ranks, nbytes):
    pof2 = 1
    while pof2 * 2 <= ranks:
        pof2 *= 2
    rem = ranks - pof2
    for rank in range(ranks):
        p = progs[rank]
        if rank < 2 * rem:
            if rank % 2 == 0:
                p.send(rank + 1, TAG_ALLREDUCE, nbytes)
                newrank = -1
            else:
                p.recv(rank - 1, TAG_ALLREDUCE)
                newrank = rank // 2
        else:
            newrank = rank - rem
        if newrank >= 0:
            mask = 1
            while mask < pof2:
                peer_new = newrank ^ mask
                peer = (peer_new * 2 + 1 if peer_new < rem
                        else peer_new + rem)
                p.sendrecv(peer, peer, nbytes,
                           TAG_ALLREDUCE, TAG_ALLREDUCE)
                mask <<= 1
        if rank < 2 * rem:
            if rank % 2:
                p.send(rank - 1, TAG_ALLREDUCE, nbytes)
            else:
                p.recv(rank + 1, TAG_ALLREDUCE)


def seq_allreduce_rdb(ranks: int, nbytes: float) -> CollectiveSchedule:
    """coll.allreduce_rdb (recursive doubling with non-power-of-two
    fold-in).  Every transfer ships the full ``nbytes`` payload."""
    progs = [Prog() for _ in range(ranks)]
    _emit_allreduce_rdb(progs, ranks, nbytes)
    return build_schedule(progs)


def seq_allreduce_lr(ranks: int, count_elems: int,
                     elem_bytes: float = 8.0) -> CollectiveSchedule:
    """coll.allreduce_lr: logical-ring reduce-scatter + all-gather on
    an ndarray of ``count_elems`` elements, including the observable
    quirks — the initial sendrecv-to-self copy (rides the loopback
    link) and the ``count_elems % ranks`` remainder folded by a
    recursive allreduce (which, at len < ranks, is rdb)."""
    progs = [Prog() for _ in range(ranks)]
    if count_elems < ranks:
        # the "not support" fallback (allreduce-lr.cpp:41-45)
        _emit_allreduce_rdb(progs, ranks, count_elems * elem_bytes)
        return build_schedule(progs)
    count = count_elems // ranks
    remainder = count_elems % ranks
    chunk = count * elem_bytes
    for rank in range(ranks):
        p = progs[rank]
        p.sendrecv(rank, rank, chunk, TAG_ALLREDUCE, TAG_ALLREDUCE)
        for _ in range(ranks - 1):          # reduce-scatter
            p.sendrecv((rank + 1) % ranks, (rank - 1 + ranks) % ranks,
                       chunk, TAG_ALLREDUCE, TAG_ALLREDUCE)
        for _ in range(ranks - 1):          # all-gather
            p.sendrecv((rank + 1) % ranks, (rank - 1 + ranks) % ranks,
                       chunk, TAG_ALLREDUCE, TAG_ALLREDUCE)
    if remainder:
        _emit_allreduce_rdb(progs, ranks, remainder * elem_bytes)
    return build_schedule(progs)


def seq_alltoall_pairwise(ranks: int,
                          block_bytes: float) -> CollectiveSchedule:
    """coll.alltoall_pairwise: ranks-1 shifted sendrecv steps."""
    progs = [Prog() for _ in range(ranks)]
    for rank in range(ranks):
        p = progs[rank]
        for step in range(1, ranks):
            dst = (rank + step) % ranks
            src = (rank - step + ranks) % ranks
            p.sendrecv(dst, src, block_bytes,
                       TAG_ALLTOALL, TAG_ALLTOALL)
    return build_schedule(progs)


def seq_alltoall_bruck(ranks: int) -> CollectiveSchedule:
    """coll.alltoall_bruck: log2(n) rounds shipping combined blocks.
    The combined payload is a python dict, so every transfer simulates
    at payload_size's object fallback (8 bytes) regardless of block
    size — exactly what the host implementation posts."""
    progs = [Prog() for _ in range(ranks)]
    for rank in range(ranks):
        p = progs[rank]
        pof2 = 1
        while pof2 < ranks:
            to = (rank + pof2) % ranks
            frm = (rank - pof2 + ranks) % ranks
            p.sendrecv(to, frm, _OBJ_BYTES, TAG_ALLTOALL, TAG_ALLTOALL)
            pof2 <<= 1
    return build_schedule(progs)


#: algorithm registry for CollectiveSpec / campaign sweeps: name ->
#: (generator, payload semantics).  "bytes" generators take a payload
#: byte count; "elems" (lr) takes an element count.
GENERATORS = {
    ("allreduce", "redbcast"): (seq_allreduce_redbcast, "bytes"),
    ("allreduce", "rdb"): (seq_allreduce_rdb, "bytes"),
    ("allreduce", "lr"): (seq_allreduce_lr, "elems"),
    ("alltoall", "pairwise"): (seq_alltoall_pairwise, "bytes"),
    ("alltoall", "bruck"): (seq_alltoall_bruck, None),
    ("bcast", "binomial_tree"): (seq_bcast_binomial, "bytes"),
    ("reduce", "default"): (seq_reduce_flat, "bytes"),
}


def generate(op: str, algo: str, ranks: int,
             payload: float) -> CollectiveSchedule:
    """Build the schedule for (op, algo) at ``ranks`` with ``payload``
    (bytes, or elements for lr; ignored by bruck)."""
    try:
        fn, mode = GENERATORS[(op, algo)]
    except KeyError:
        raise ValueError(f"no schedule generator for {op}/{algo}; "
                         f"known: {sorted(GENERATORS)}") from None
    if mode is None:
        return fn(ranks)
    if mode == "elems":
        return fn(ranks, int(payload))
    return fn(ranks, float(payload))
