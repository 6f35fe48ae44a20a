"""Wire messages of the MoDeST protocol with byte-size accounting.

Model payloads travel either as real parameter pytrees (learning
experiments) or as an abstract byte count (protocol/network experiments at
full published model sizes without doing the FLOPs — e.g. Table 4 rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.views import View
from repro_torch.utils.pytree import tree_size_bytes

HEADER_BYTES = 24      # UDP/IPv8-style framing + ids + round number


@dataclass
class Message:
    sender: str

    def size_bytes(self) -> int:
        return HEADER_BYTES


@dataclass
class Ping(Message):
    round_k: int = 0

    def size_bytes(self) -> int:
        return HEADER_BYTES


@dataclass
class Pong(Message):
    round_k: int = 0

    def size_bytes(self) -> int:
        return HEADER_BYTES


@dataclass
class Ack(Message):
    """Aggregator -> trainer: your round-k model arrived. Only emitted
    when failover is enabled (``ModestConfig.failover``): it exists to
    cancel the trainer's failover watch, so healthy pushes don't trigger
    spurious re-sends just because the trainer wasn't sampled into the
    next round and never observed its progress."""

    round_k: int = 0

    def size_bytes(self) -> int:
        return HEADER_BYTES


@dataclass
class Joined(Message):
    node: str = ""
    counter: int = 0

    def size_bytes(self) -> int:
        return HEADER_BYTES + 16


@dataclass
class Left(Message):
    node: str = ""
    counter: int = 0

    def size_bytes(self) -> int:
        return HEADER_BYTES + 16


@dataclass
class ModelPayload:
    """Either a real pytree or an abstract size-only stand-in."""

    params: Any = None
    nbytes: Optional[int] = None

    def size_bytes(self) -> int:
        if self.nbytes is not None:
            return self.nbytes
        if self.params is not None:
            return tree_size_bytes(self.params)
        return 0


@dataclass
class TrainMsg(Message):
    """Aggregator -> participant: train on this model (Alg. 4 ``train``).

    ``roster`` is the full sampled cohort S^k, piggybacked only when
    secure aggregation is on (``ModestConfig.secure_agg``): each trainer
    needs the roster to derive pairwise mask seeds and to address its
    Shamir shares. Empty by default so plain sessions pay zero extra
    wire bytes and golden trajectories are untouched.
    """

    round_k: int = 0
    model: ModelPayload = field(default_factory=ModelPayload)
    view: Optional[View] = None
    roster: tuple = ()

    def size_bytes(self) -> int:
        v = self.view.size_bytes() if self.view else 0
        return HEADER_BYTES + self.model.size_bytes() + v + 8 * len(self.roster)


@dataclass
class AggregateMsg(Message):
    """Participant -> aggregator: my updated model (Alg. 4 ``aggregate``)."""

    round_k: int = 0
    model: ModelPayload = field(default_factory=ModelPayload)
    view: Optional[View] = None

    def size_bytes(self) -> int:
        v = self.view.size_bytes() if self.view else 0
        return HEADER_BYTES + self.model.size_bytes() + v


# --------------------------------------------------------------------------
# Secure aggregation (repro_torch.secureagg, docs/SECUREAGG.md). All four kinds
# travel through the one ``Network.send -> injector.transit`` interception
# point like every other protocol message, so fault schedules see them and
# ``usage_summary()`` accounts their bytes.


@dataclass
class MaskedModelMsg(AggregateMsg):
    """Participant -> aggregator: my updated model under a pairwise mask.

    Subclasses :class:`AggregateMsg` (same round/model/view slots and the
    same receive path — ack, view merge, stale/duplicate guards) but the
    payload's ``params`` is a ``repro_torch.secureagg.masking.SealedModel``:
    only masked bit patterns are on the wire. ``roster`` names the cohort
    the mask was built over; the aggregator groups rows by roster.
    """

    roster: tuple = ()

    def size_bytes(self) -> int:
        return super().size_bytes() + 8 * len(self.roster)


@dataclass
class ShareMsg(Message):
    """Trainer -> cohort member: one Shamir share of my per-round mask
    secret (modelled as pairwise-encrypted opaque bytes: 8B owner id +
    2B share index + 8B field element + AEAD overhead)."""

    round_k: int = 0
    owner: str = ""
    share: tuple = (0, 0)            # (x, y) over the Shamir field

    def size_bytes(self) -> int:
        return HEADER_BYTES + 34


@dataclass
class UnmaskReq(Message):
    """Aggregator -> survivors: round-k models collected from
    ``survivors``; send me the shares you hold so the masks can be
    removed (threshold-gated, see docs/SECUREAGG.md)."""

    round_k: int = 0
    roster: tuple = ()
    survivors: tuple = ()

    def size_bytes(self) -> int:
        return HEADER_BYTES + 8 * (len(self.roster) + len(self.survivors))


@dataclass
class UnmaskShareMsg(Message):
    """Survivor -> aggregator: the Shamir shares this node holds for the
    round (one ``(owner, x, y)`` triple per roster member heard from)."""

    round_k: int = 0
    shares: tuple = ()               # ((owner, x, y), ...)

    def size_bytes(self) -> int:
        return HEADER_BYTES + 24 * len(self.shares)


# --------------------------------------------------------------------------
# Serving (repro_torch.serve, docs/SERVE.md). Snapshots, queries and responses
# all travel through ``Network.send`` like protocol traffic, so contention
# shapes them, fault schedules see them, and ``usage_summary()`` accounts
# their bytes per message type (``SnapshotMsg`` rows are the snapshot
# fan-out cost; ``RequestMsg``/``ResponseMsg`` rows are the query plane).


@dataclass
class SnapshotMsg(Message):
    """Training frontier -> serving replica: the round-k servable snapshot
    (full model payload; replicas install monotonically by round)."""

    round_k: int = 0
    model: ModelPayload = field(default_factory=ModelPayload)

    def size_bytes(self) -> int:
        return HEADER_BYTES + 8 + self.model.size_bytes()


@dataclass
class RequestMsg(Message):
    """Query client -> replica: one inference request for ``method``.
    ``nbytes`` is the opaque request body (tokens/features); the replica's
    admission queue may still reject it (see ResponseMsg.dropped)."""

    req_id: int = 0
    method: str = "predict"
    nbytes: int = 1024

    def size_bytes(self) -> int:
        return HEADER_BYTES + 16 + self.nbytes


@dataclass
class ResponseMsg(Message):
    """Replica -> client: the answer (``dropped == ""``) carrying the
    round of the snapshot that served it, or a small rejection notice
    (``"admission"`` queue full / ``"deadline"`` expired in queue /
    ``"unloaded"`` no snapshot installed yet)."""

    req_id: int = 0
    round_k: int = 0                 # round of the serving snapshot
    nbytes: int = 1024
    dropped: str = ""

    def size_bytes(self) -> int:
        body = 0 if self.dropped else self.nbytes
        return HEADER_BYTES + 16 + body
