"""Step-wise executor protocol (the fleet substrate).

Every query executor is written as a *stepper*: a generator that runs
the executor's historical discrete-event loop unchanged, but yields a
work item whenever it needs something from the outside world and
receives the answer from ``send()``:

  ``ScoreDemand(trained, idxs)``  -> responds ``(probs, counts)``
      operator inference over frame indices.  Standalone drivers answer
      through ``QuerySession.score``; the ``FleetScheduler`` feeds a
      ``ScoreBatcher`` that fuses chunks from many concurrent queries
      into stacked superbatch dispatches issued eagerly while the tick
      loop runs, deferring results on-device (``ScoreHandle``) until
      the stepper resumes.  The protocol contract is that *any* driver
      answers with arrays bit-identical to single-demand scoring —
      every ``OperatorRuntime`` dispatch layer guarantees this, so
      steppers never observe how their scoring was batched or when it
      was dispatched.

  ``UploadTick(seconds, nbytes)`` -> responds ``float`` (actual seconds)
      one uplink transfer.  ``seconds`` is the *uncontended* duration,
      computed by the executor exactly as the pre-stepper code did (so
      an uncontended driver echoing it back reproduces the historical
      clock bit-for-bit).  A contended driver returns a stretched
      duration (shared camera uplink / cloud ingress).

  ``VerifyDemand(idx, cls, at)``  -> responds ``(pos, cnt)``
      cloud-side verification of one uploaded frame with the expensive
      detector — exactly what ``env.cloud_verify`` returns.  Standalone
      ``drive()`` answers synchronously through ``env.cloud_verify``
      (bit-identical to the historical inline call); the
      ``FleetScheduler`` routes concurrent demands through a shared
      ``serving/oracle_service.OracleService``, which batches them over
      fixed verification slots under admission control.  The answer is
      a pure, deterministic function of ``(video, idx, cls, detector)``
      — independent of how demands were batched — and the scheduler
      resumes each demanding stepper at the demand's simulated-time
      position, so routed runs stay bit-identical to inline ones.
      Like ``UploadTick``, ``at`` is the demand's *simulated* time (the
      moment the verified upload completed); services use it for
      queueing-delay accounting and SLO deadlines, never to stretch the
      stepper's clock (verification is instantaneous in query time,
      exactly as the pre-service inline call was).  ``qid``/``priority``
      are stamped by the routing driver (the stepper does not know its
      fleet identity).

The generator's ``return`` value is the query's ``Progress``.  Because
the stepper bodies are the same code that used to live in ``run()``
(same RNG streams, same event ordering), a stepper driven by ``drive``
is bit-identical to the pre-refactor executor, and a stepper driven by
an uncontended ``FleetScheduler`` is bit-identical to ``drive``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generator, Optional, Tuple

import numpy as np

WorkItem = Any          # ScoreDemand | UploadTick | VerifyDemand
Stepper = Generator     # Generator[WorkItem, Any, "Progress"]


@dataclass
class ScoreDemand:
    """Operator inference request: score ``idxs`` with ``trained``.

    Response: ``(probs, counts)`` float64 numpy arrays, one entry per
    index — exactly what ``QuerySession.score`` returns.
    """
    trained: Any               # TrainedOp
    idxs: np.ndarray


@dataclass
class VerifyDemand:
    """Cloud verification request for one uploaded frame.

    Response: ``(pos, cnt)`` — presence and object count of ``cls`` in
    frame ``idx`` under the cloud detector, exactly
    ``env.cloud_verify(idx)``.  ``at`` is the simulated time the upload
    completed (the same contract as ``UploadTick.at``: it feeds service
    queueing/SLO accounting, never the stepper's clock).  ``qid`` and
    ``priority`` are stamped by the routing driver — a stepper always
    yields them at their defaults."""
    idx: int
    cls: str
    at: float = 0.0
    qid: Optional[str] = None
    priority: int = 0


@dataclass
class UploadTick:
    """One uplink transfer of ``nbytes`` whose uncontended duration is
    ``seconds``, starting at the query's simulated time ``at``.
    Response: the actual duration in seconds (equal to ``seconds`` when
    the uplink is uncontended; a contended driver stretches it by the
    number of queries sharing the link at ``at``)."""
    seconds: float
    nbytes: float = 0.0
    at: float = 0.0


def drive(gen: Stepper, session=None, *,
          score: Optional[Callable[[ScoreDemand],
                                   Tuple[np.ndarray, np.ndarray]]] = None,
          verify: Optional[Callable[[VerifyDemand],
                                    Tuple[bool, int]]] = None,
          env=None):
    """Run a stepper to completion standalone: uncontended uplink,
    scoring through ``session.score`` (or a custom ``score`` callback),
    and verification answered synchronously through ``env.cloud_verify``
    (``env`` defaults to ``session.env``; or a custom ``verify``
    callback).  Synchronous single-query verification is the historical
    inline path, so standalone runs stay bit-identical to the
    pre-VerifyDemand executors.  Returns the generator's return value
    (the ``Progress``)."""
    if score is None and session is not None:
        def score(d):  # default: the session fast path
            return session.score(d.trained, d.idxs)
    if env is None and session is not None:
        env = session.env
    if verify is None and env is not None:
        def verify(d):  # default: the env's authoritative cloud detector
            return env.cloud_verify(d.idx)
    resp = None
    while True:
        try:
            item = gen.send(resp)
        except StopIteration as e:
            return e.value
        if isinstance(item, ScoreDemand):
            if score is None:
                raise RuntimeError(
                    "stepper yielded a ScoreDemand but drive() was given "
                    "no session/score callback")
            resp = score(item)
        elif isinstance(item, UploadTick):
            resp = item.seconds
        elif isinstance(item, VerifyDemand):
            if verify is None:
                raise RuntimeError(
                    "stepper yielded a VerifyDemand but drive() was given "
                    "no session/env/verify callback")
            resp = verify(item)
        else:
            raise TypeError(f"unknown work item: {item!r}")
