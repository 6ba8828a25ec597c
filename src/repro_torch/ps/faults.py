"""Fault vocabulary for the tick engines: quarantine errors and a
deterministic, seedable fault injector.

Parameter Service is a *shared* aggregation fleet: many jobs depend on
the same shard spaces, so a failed apply on one shard must not take the
whole engine down.  PR 7 replaces the engines' whole-process ``_poisoned``
flag with per-lane health (``HEALTHY`` / ``QUARANTINED``) plus
snapshot-based rollback (see ``repro.ps.engine``); this module holds the
pieces both the engine and its tests share:

``EngineQuarantinedError``
    Raised when work is blocked on a lane that stopped ticking.  Carries
    the shard id, the lane-local tick number, the pending job ids, and
    the ORIGINAL exception -- the old poisoned ``RuntimeError`` said none
    of that.

``FaultInjector``
    A deterministic fault schedule hookable at the engines' apply, push,
    and migration boundaries: fail the N-th apply on a shard, kill a
    shard outright, drop or duplicate a push piece, fail a migration.
    Rules count their OWN matching occurrences, so a schedule is a pure
    function of the call sequence -- the chaos tests replay it and
    compare against a fault-free twin bit for bit.  ``seed`` drives only
    the convenience random-schedule builder; armed rules are exact.

Injected faults raise :class:`InjectedFault` (a ``RuntimeError``), so
they route through exactly the recovery paths a real device/runtime
error would.

Rollback recovery is compression-safe (PR 8): a compressed-push job's
error-feedback buffer (``state["ef"]``) lives in the lane's donated
state, so the last-good snapshot captures it and a replay restarts the
EF recurrence from the exact residual it held -- at ``max_staleness=0``
a recovered compressed trajectory is bit-exact with a fault-free
compressed twin (see tests/test_faults.py).
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "HEALTHY",
    "QUARANTINED",
    "EngineQuarantinedError",
    "InjectedFault",
    "FaultInjector",
    "LeaseExpiredError",
    "ReplanAbortedError",
    "RetryPolicy",
]

# Lane health states (a lane is one shard space's service loop; the flat
# engine is a single unnamed lane).
HEALTHY = "healthy"
QUARANTINED = "quarantined"


class InjectedFault(RuntimeError):
    """The exception a :class:`FaultInjector` rule raises when it fires."""

    def __init__(self, kind: str, *, shard_id: Optional[str] = None,
                 job_id: Optional[str] = None, occurrence: int = 0):
        self.kind = kind
        self.shard_id = shard_id
        self.job_id = job_id
        self.occurrence = int(occurrence)
        where = f" on shard {shard_id!r}" if shard_id is not None else ""
        who = f" (job {job_id!r})" if job_id is not None else ""
        super().__init__(
            f"injected {kind} fault{where}{who} at occurrence "
            f"{occurrence}")


class EngineQuarantinedError(RuntimeError):
    """A lane exhausted its apply retries (or had no snapshot to roll
    back to) and stopped ticking.

    Attributes carry the triage context the old poisoned ``RuntimeError``
    lacked: ``shard_id`` (``None`` for the flat engine's single lane),
    ``tick`` (the lane-local tick count when it failed), ``job_ids``
    (the pushes in the failed apply), and ``original`` (the underlying
    exception).  Healthy lanes keep ticking; recover the quarantined one
    with ``ShardedServiceRuntime.recover_shard(shard_id)`` or restore a
    checkpoint.
    """

    def __init__(self, *, shard_id: Optional[str], tick: int, job_ids,
                 original: BaseException):
        self.shard_id = shard_id
        self.tick = int(tick)
        self.job_ids = tuple(job_ids)
        self.original = original
        lane = ("the engine's lane" if shard_id is None
                else f"shard {shard_id!r}")
        remedy = ("restore a checkpoint or re-seed the runtime"
                  if shard_id is None else
                  f"ShardedServiceRuntime.recover_shard({shard_id!r}) "
                  f"re-hosts it on the surviving fleet (or restore a "
                  f"checkpoint)")
        super().__init__(
            f"{lane} is quarantined: apply of jobs "
            f"{sorted(self.job_ids)} failed at lane tick {self.tick} "
            f"with {type(original).__name__}: {original}; its state was "
            f"restored to the last-good snapshot and healthy lanes keep "
            f"ticking -- {remedy}")


class ReplanAbortedError(RuntimeError):
    """A replan transaction exhausted its retries and was rolled back.

    ``ParameterService`` runs every registry mutation (register/exit/
    scale/evacuate) as a commit-or-abort transaction (PR 9): when a
    listener -- i.e. the data plane's quiesce -> migrate -> commit
    sequence -- fails, the registry is restored to its pre-transaction
    snapshot and the mutation is retried under a :class:`RetryPolicy`.
    This error means every attempt failed; control and data plane are
    left AGREEING on the old layout.  ``original`` carries the last
    underlying failure.
    """

    def __init__(self, op: str, attempts: int, original: BaseException):
        self.op = op
        self.attempts = int(attempts)
        self.original = original
        super().__init__(
            f"replan transaction {op!r} aborted after {attempts} "
            f"attempt(s): {type(original).__name__}: {original}; the "
            f"task registry was rolled back to its pre-transaction "
            f"snapshot, so control and data plane agree on the old "
            f"layout")


class LeaseExpiredError(RuntimeError):
    """A job's lease lapsed and the engine reclaimed it.

    Pushes and pulls renew a job's lease; a trainer that dies silently
    stops renewing, and ``expire_leases()`` cancels its queued pieces
    with this error and removes the job through the transactional
    replan path, freeing its space for the autoscaler.
    """

    def __init__(self, job_id: str, deadline: float, now: float):
        self.job_id = job_id
        self.deadline = float(deadline)
        self.now = float(now)
        super().__init__(
            f"job {job_id!r} lease expired at t={deadline:g} "
            f"(now t={now:g}): its trainer stopped pushing/pulling, so "
            f"the engine cancelled its queued pieces and reclaimed its "
            f"space -- re-register the job to resume")


@dataclass
class RetryPolicy:
    """Bounded-attempts + exponential-backoff retry schedule, shared by
    the apply path (PR 7's snapshot-rollback retries) and the replan
    transactions (PR 9).

    ``should_retry(failures)`` is consulted with the number of
    CONSECUTIVE failures so far (1-based); ``backoff(attempt)`` sleeps
    ``min(max_delay, base_delay * 2**(attempt-1))`` seconds.  The
    default ``base_delay=0.0`` disables sleeping (deterministic tests);
    ``sleep`` is injectable for the same reason.
    """

    max_retries: int = 2
    base_delay: float = 0.0
    max_delay: float = 1.0
    sleep: Callable[[float], None] = time.sleep

    def should_retry(self, failures: int) -> bool:
        return failures <= self.max_retries

    def delay(self, attempt: int) -> float:
        if self.base_delay <= 0.0:
            return 0.0
        return min(self.max_delay,
                   self.base_delay * (2.0 ** (max(attempt, 1) - 1)))

    def backoff(self, attempt: int) -> float:
        d = self.delay(attempt)
        if d > 0.0:
            self.sleep(d)
        return d


@dataclass
class _Rule:
    """One armed fault: fires on matching occurrences ``at`` through
    ``at + times - 1`` (1-based), counted per rule."""

    kind: str  # 'fail_apply' | 'drop_push' | 'duplicate_push' |
    #            'fail_migration'
    shard_id: Optional[str] = None  # None = any shard / the flat lane
    job_id: Optional[str] = None  # push rules: None = any job
    at: int = 1
    times: float = 1  # math.inf = permanent (a killed shard)
    seen: int = 0  # matching occurrences observed so far
    fired: int = 0
    # fail_migration only: None = fire at the migration BOUNDARY (before
    # any shard is relaid); K = fire mid-migration, after K shards of
    # the new plan have been relaid (abort-safety probe).
    after_shards: Optional[int] = None

    def matches(self, shard_id: Optional[str],
                job_id: Optional[str]) -> bool:
        if self.shard_id is not None and self.shard_id != shard_id:
            return False
        if self.job_id is not None and self.job_id != job_id:
            return False
        return True

    def observe(self) -> bool:
        """Count one matching occurrence; True if the rule fires on it."""
        self.seen += 1
        if self.seen >= self.at and self.fired < self.times:
            self.fired += 1
            return True
        return False


class FaultInjector:
    """Deterministic fault schedule for the tick engines.

    Arm rules, hand the injector to ``attach_engine(fault_injector=...)``
    (or an engine ctor), and every fired fault is recorded in ``log``::

        inj = FaultInjector(seed=7)
        inj.fail_apply(shard_id="c0/a1", at=3)   # 3rd apply on that lane
        inj.kill_shard("c0/a0", at=5)            # every apply from the 5th
        inj.drop_push(job_id="a", at=2)          # lose a's 2nd piece
        eng = rt.attach_engine(max_staleness=0, fault_injector=inj)

    Hooks (called by the engines; a rule firing raises
    :class:`InjectedFault` for apply/migration, or returns an action for
    pushes):

    * ``on_apply(shard_id)`` -- before each lane apply (``None`` for the
      flat engine's single lane).
    * ``on_push(job_id, shard_id)`` -- per enqueued piece; returns
      ``"deliver"``, ``"drop"``, or ``"duplicate"``.
    * ``on_migration(desc)`` -- at each state-migration boundary.
    * ``on_migration_progress(n_relaid, desc)`` -- after each shard of a
      sharded migration is relaid (mid-migration fail points).
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.rules: List[_Rule] = []
        self.log: List[Dict[str, Any]] = []  # every fired fault

    # -------------------------------------------------------------- arming
    def fail_apply(self, shard_id: Optional[str] = None, *, at: int = 1,
                   times: float = 1) -> "FaultInjector":
        """Fail the ``at``-th (1-based) apply on ``shard_id`` (any lane if
        None), ``times`` consecutive occurrences."""
        self.rules.append(_Rule("fail_apply", shard_id=shard_id, at=at,
                                times=times))
        return self

    def kill_shard(self, shard_id: Optional[str], *,
                   at: int = 1) -> "FaultInjector":
        """Permanently fail every apply on ``shard_id`` from its ``at``-th
        on -- the abrupt-shard-loss fault (drives quarantine, then
        ``recover_shard``)."""
        self.rules.append(_Rule("fail_apply", shard_id=shard_id, at=at,
                                times=math.inf))
        return self

    def drop_push(self, job_id: Optional[str] = None,
                  shard_id: Optional[str] = None, *, at: int = 1,
                  times: float = 1) -> "FaultInjector":
        """Silently lose a matching enqueued push piece (its future never
        resolves -- pair with ``PushFuture.result(timeout=...)``)."""
        self.rules.append(_Rule("drop_push", shard_id=shard_id,
                                job_id=job_id, at=at, times=times))
        return self

    def duplicate_push(self, job_id: Optional[str] = None,
                       shard_id: Optional[str] = None, *, at: int = 1,
                       times: float = 1) -> "FaultInjector":
        """Deliver a matching piece TWICE (an at-least-once delivery bug:
        the duplicate applies as an extra untracked push)."""
        self.rules.append(_Rule("duplicate_push", shard_id=shard_id,
                                job_id=job_id, at=at, times=times))
        return self

    def fail_migration(self, *, at: int = 1, times: float = 1,
                       after_shards: Optional[int] = None
                       ) -> "FaultInjector":
        """Fail the ``at``-th state migration.

        With ``after_shards=None`` (default) the fault fires at the
        migration BOUNDARY, before any shard is relaid.  With
        ``after_shards=K`` it fires MID-migration, once K shards of the
        new plan have been relaid -- ``migrate_sharded_state`` is
        functional over its input states, so an abort at that point must
        leave the old states untouched (the replan transaction's
        abort-safety probe).  ``at`` counts matching migrations, not
        shards.
        """
        self.rules.append(_Rule("fail_migration", at=at, times=times,
                                after_shards=after_shards))
        return self

    def random_apply_faults(self, n: int, shard_ids, *,
                            max_at: int = 20) -> "FaultInjector":
        """Arm ``n`` TRANSIENT apply faults at seed-deterministic (shard,
        occurrence) points -- the chaos tests' schedule builder."""
        sids = list(shard_ids)
        for _ in range(n):
            self.fail_apply(self.rng.choice(sids) if sids else None,
                            at=self.rng.randint(1, max_at))
        return self

    # --------------------------------------------------------------- hooks
    def _fire(self, rule: _Rule, shard_id, job_id) -> InjectedFault:
        fault = InjectedFault(rule.kind, shard_id=shard_id, job_id=job_id,
                              occurrence=rule.seen)
        self.log.append({"kind": rule.kind, "shard_id": shard_id,
                         "job_id": job_id, "occurrence": rule.seen})
        return fault

    def on_apply(self, shard_id: Optional[str]) -> None:
        """Raise InjectedFault if an armed apply rule fires on this
        occurrence for this lane."""
        for rule in self.rules:
            if rule.kind != "fail_apply" or not rule.matches(shard_id,
                                                             None):
                continue
            if rule.observe():
                raise self._fire(rule, shard_id, None)

    def on_push(self, job_id: str, shard_id: Optional[str] = None) -> str:
        """Per-piece delivery decision: 'deliver' | 'drop' | 'duplicate'
        (first firing rule wins)."""
        action = "deliver"
        for rule in self.rules:
            if rule.kind not in ("drop_push", "duplicate_push"):
                continue
            if not rule.matches(shard_id, job_id):
                continue
            if rule.observe() and action == "deliver":
                self._fire(rule, shard_id, job_id)
                action = ("drop" if rule.kind == "drop_push"
                          else "duplicate")
        return action

    def on_migration(self, desc: str = "") -> None:
        """Raise InjectedFault if an armed BOUNDARY migration rule fires
        (mid-migration rules wait for ``on_migration_progress``)."""
        for rule in self.rules:
            if rule.kind != "fail_migration" or rule.after_shards is not None:
                continue
            if rule.observe():
                raise self._fire(rule, None, desc or None)

    def on_migration_progress(self, n_relaid: int, desc: str = "") -> None:
        """Raise InjectedFault if a mid-migration rule armed for this
        progress point (``after_shards == n_relaid``) fires.  Called by
        ``migrate_sharded_state`` after each shard of the new plan is
        relaid; each matching call is one occurrence of the rule, so
        ``at`` counts migrations reaching that point."""
        for rule in self.rules:
            if rule.kind != "fail_migration" or rule.after_shards is None:
                continue
            if rule.after_shards != n_relaid:
                continue
            if rule.observe():
                raise self._fire(
                    rule, None,
                    f"{desc or 'migration'}@after_shards={n_relaid}")

    # ---------------------------------------------------------- inspection
    @property
    def n_fired(self) -> int:
        return len(self.log)

    def fire_counts(self) -> Dict[str, int]:
        """Fired-fault counts by rule kind (from ``log``) -- surfaced in
        the runtimes' ``debug_stats()``."""
        counts: Dict[str, int] = {}
        for entry in self.log:
            counts[entry["kind"]] = counts.get(entry["kind"], 0) + 1
        return counts
