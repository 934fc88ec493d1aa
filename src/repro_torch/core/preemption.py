"""Preemption protocol — the adaptation of the paper's 'Terminate' (a copy of
``repro.core.preemption``, which needs only the port's own ``Instance``).

In the paper, terminating a VM is a kill.  A preemptible *training job*
carries state, so `repro` turns termination into a two-phase protocol
(mirroring GCE's preemption notice):

    1. PREEMPT(job, deadline)  — scheduler decision; controller signals job.
    2. the job drains its in-flight step, writes an async checkpoint,
       acks DRAINED; past the deadline the controller hard-kills (spot
       semantics) and the job loses work since its last periodic checkpoint.
    3. the instance is evacuated; the job is re-queued (elastic: it may
       resume later on a different slice shape).

The controller is transport-agnostic: in-process here, gRPC/etcd in a real
deployment.  Everything is synchronous & deterministic for testability.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Protocol

from .types import Instance


class PreemptAck(enum.Enum):
    DRAINED = "drained"          # checkpoint written before deadline
    HARD_KILLED = "hard_killed"  # deadline exceeded; work since last ckpt lost


class PreemptibleJob(Protocol):
    """What a running job must expose to the controller."""

    job_id: str

    def on_preempt(self, now: float, deadline: float) -> PreemptAck:
        """Drain + checkpoint.  Return DRAINED if finished by ``deadline``."""
        ...


@dataclasses.dataclass
class PreemptionRecord:
    instance_id: str
    job_id: str
    time: float
    ack: PreemptAck
    #: seconds of training lost (0 when drained in time).
    lost_work_s: float


class PreemptionController:
    """Routes scheduler preemption decisions to job runtimes.

    Registered as a ``Cluster.preempt_hooks`` member: every evacuation decided
    by the scheduler flows through ``__call__`` before the instance is removed
    from its host.
    """

    def __init__(self, notice_s: float = 30.0):
        #: the preemption notice window (GCE gives 30 s).
        self.notice_s = notice_s
        self._jobs: Dict[str, PreemptibleJob] = {}
        self.records: List[PreemptionRecord] = []

    # -- registry -------------------------------------------------------------
    def register(self, instance_id: str, job: PreemptibleJob) -> None:
        self._jobs[instance_id] = job

    def unregister(self, instance_id: str) -> None:
        self._jobs.pop(instance_id, None)

    # -- Cluster hook ----------------------------------------------------------
    def __call__(self, inst: Instance, now: float) -> None:
        job = self._jobs.pop(inst.id, None)
        if job is None:
            # Stateless instance (serving replica): nothing to drain.
            self.records.append(
                PreemptionRecord(inst.id, "-", now, PreemptAck.DRAINED, 0.0)
            )
            return
        deadline = now + self.notice_s
        ack = job.on_preempt(now, deadline)
        if ack is PreemptAck.DRAINED:
            lost = 0.0
            inst.last_checkpoint = now
        else:
            anchor = inst.last_checkpoint if inst.last_checkpoint is not None else inst.start_time
            lost = max(0.0, now - anchor)
        self.records.append(
            PreemptionRecord(inst.id, job.job_id, now, ack, lost)
        )

    # -- metrics ---------------------------------------------------------------
    @property
    def total_lost_work_s(self) -> float:
        return sum(r.lost_work_s for r in self.records)

    @property
    def drain_rate(self) -> float:
        if not self.records:
            return 1.0
        drained = sum(1 for r in self.records if r.ack is PreemptAck.DRAINED)
        return drained / len(self.records)
