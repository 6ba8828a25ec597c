"""Tensor migration protocol (paper §3.2 + Appendix B).

State machine, data-consistency invariants, and an analytic overlap model of
worker-visible stall. The data-plane counterpart (actual JAX resharding of
parameter + optimizer-state arrays) lives in `repro.ps.elastic`; this module
is the control-plane protocol both the simulator and the runtime drive.

Protocol (App. B, Fig. 13):
  MIGRATE_INIT   pMaster -> old owner: remember (tensor, new owner)
  PULL_RESPONSE  old owner piggybacks new-owner identity on the next Pull;
                 every Agent updates its mapping table on receipt
  TENSOR_COPY    old -> new owner, overlapped with the worker's fwd/bwd window
  TENSOR_COPY_DONE  old owner -> pMaster
  PUSH           workers push this iteration's gradient to the NEW owner
  WORKER_DONE    new owner -> pMaster once pushes arrive
  COMPLETE       pMaster saw both notifications

Consistency invariants (App. B "Data Consistency"):
  I1  Agents route by mapping table; the table is updated atomically with the
      Pull response, so no Agent can push to the old owner after repointing.
  I2  The new owner must not run Update on the tensor before TENSOR_COPY_DONE
      (the master copy would be stale).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class MigrationState(enum.Enum):
    IDLE = "idle"
    INIT = "migrate_init"
    REPOINTED = "pull_piggybacked"  # Agents know the new owner
    COPYING = "tensor_copy"
    COPY_DONE = "tensor_copy_done"
    WORKER_DONE = "worker_done"
    COMPLETE = "complete"


_VALID = {
    MigrationState.IDLE: {MigrationState.INIT},
    MigrationState.INIT: {MigrationState.REPOINTED},
    MigrationState.REPOINTED: {MigrationState.COPYING},
    MigrationState.COPYING: {MigrationState.COPY_DONE},
    MigrationState.COPY_DONE: {MigrationState.WORKER_DONE},
    MigrationState.WORKER_DONE: {MigrationState.COMPLETE},
    MigrationState.COMPLETE: set(),
}


class ProtocolError(RuntimeError):
    pass


@dataclass
class TensorMigration:
    """Tracks one tensor's migration through the protocol."""

    job_id: str
    tensor_id: int
    src_aggregator: str
    dst_aggregator: str
    state: MigrationState = MigrationState.IDLE
    history: List[MigrationState] = field(default_factory=list)

    def advance(self, to: MigrationState) -> None:
        if to not in _VALID[self.state]:
            raise ProtocolError(
                f"invalid transition {self.state.value} -> {to.value} "
                f"for tensor {self.tensor_id} of {self.job_id}"
            )
        self.history.append(self.state)
        self.state = to

    # Invariant I2: Update is legal on dst only after the copy landed.
    def update_allowed_on(self, aggregator_id: str) -> bool:
        if aggregator_id == self.dst_aggregator:
            return self.state in (
                MigrationState.COPY_DONE,
                MigrationState.WORKER_DONE,
                MigrationState.COMPLETE,
            )
        if aggregator_id == self.src_aggregator:
            # The old owner may still serve Pull until repoint, but must not
            # apply updates once migration started (gradients now route to dst).
            return self.state == MigrationState.IDLE
        return False

    def run_to_completion(self) -> None:
        while self.state != MigrationState.COMPLETE:
            self.advance(_next(self.state))


def _next(state: MigrationState) -> MigrationState:
    (nxt,) = _VALID[state] or {state}
    return nxt


@dataclass(frozen=True)
class MigrationCost:
    """Analytic overlap model of one migration batch (App. B, Table 3)."""

    copy_time: float  # raw tensor-copy time (bytes / link bandwidth)
    window: float  # fwd/bwd window the copy can hide inside
    protocol_overhead: float  # serialization etc. ("several milliseconds")

    @property
    def visible_stall(self) -> float:
        """Worker-visible suspension: copy time beyond the hideable window
        plus the unavoidable per-migration protocol overhead."""
        return max(0.0, self.copy_time - self.window) + self.protocol_overhead


def migration_cost(
    nbytes: int,
    link_bandwidth: float,
    compute_window: float,
    protocol_overhead: float = 5e-3,
) -> MigrationCost:
    """Cost of migrating `nbytes` while the workers compute for
    `compute_window` seconds (the Pull->Update idle window of Fig. 1b)."""
    return MigrationCost(
        copy_time=nbytes / max(link_bandwidth, 1.0),
        window=compute_window,
        protocol_overhead=protocol_overhead,
    )


def checkpoint_restart_cost(
    model_bytes: int,
    storage_bandwidth: float,
    restart_overhead: float = 10.0,
) -> float:
    """The strawman the paper compares against (§3.2): pause, checkpoint,
    resume with the new assignment — 'tens of seconds' of full-job stall."""
    return 2 * model_bytes / max(storage_bandwidth, 1.0) + restart_overhead
