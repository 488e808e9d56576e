"""The port's contended fleet and shared verification service against
the JAX package's.

``tests/test_torch_fleet.py`` holds the port's uncontended fleet to its
own standalone runs. Here both packages run the same contended fleet (a
shared uplink per camera changes every query's ``done_t``), with every
verification routed through the shared ``OracleService`` under mixed
priorities, weights and an SLO. The JAX package records each operator
it trains, in call order; the port replays those weights (carried
across with ``params_from_jax``), so both decide with the same
operators and any difference comes from the port's scheduling, queueing
or scoring. The workload is ``tests/test_fleet.py``'s 8 queries at 0.1 h
per camera and 5 training steps.

The service's admission rules are held to the JAX package's directly:
the same submission scripts against a stub env give the same slot
contents, in order, and the same ``stats()`` key for key.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import fleet as jfleet  # noqa: E402
from repro.core import landmarks as jlm  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core import stepper as jstepper  # noqa: E402
from repro.core import training as jtraining  # noqa: E402
from repro.core import video as jvideo  # noqa: E402
from repro.core.hardware import YOLO_V3 as J_YOLO_V3  # noqa: E402
from repro.serving import oracle_service as joracle  # noqa: E402
from repro_torch.core import fleet as tfleet  # noqa: E402
from repro_torch.core import landmarks as tlm  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import stepper as tstepper  # noqa: E402
from repro_torch.core import training as ttraining  # noqa: E402
from repro_torch.core import video as tvideo  # noqa: E402
from repro_torch.core.hardware import YOLO_V3 as T_YOLO_V3  # noqa: E402
from repro_torch.serving import oracle_service as toracle  # noqa: E402

HOURS, STEPS = 0.1, 5
CAMERAS = ("JacksonH", "Banff", "Miami")

# 8 mixed queries over 3 cameras (tests/test_fleet.py's SPECS)
SPECS = [
    ("JacksonH", "retrieval", {"max_passes": 2}),
    ("Banff", "retrieval", {"max_passes": 2}),
    ("JacksonH", "count_max", {"max_passes": 2}),
    ("Miami", "count_max", {"max_passes": 2}),
    ("Banff", "tagging", {}),
    ("Miami", "tagging", {}),
    ("Banff", "count_avg", {}),
    ("Miami", "count_median", {}),
]

JAX = types.SimpleNamespace(video=jvideo, lm=jlm, det=J_YOLO_V3,
                            query=jquery, rt=jrt, fleet=jfleet,
                            training=jtraining)
PORT = types.SimpleNamespace(video=tvideo, lm=tlm, det=T_YOLO_V3,
                             query=tquery, rt=trt, fleet=tfleet,
                             training=ttraining)

# fleet stats that are counts of simulated events, equal in both packages
# (the host-clock reads, overlap_host_s and result_block_s, are not)
EXACT_STATS = ("queries", "cameras", "score_rounds", "dispatches",
               "eager_dispatches", "watermark_fires", "frames_scored",
               "upload_ticks", "verify_demands", "device_count", "sharded")
EXACT_ORACLE_STATS = ("frames_verified", "slots", "slot_frames",
                      "occupancy_mean", "occupancy_max", "detect_calls",
                      "dedup_hits", "overdue_bumped", "per_qid")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One torch thread: the suite runs test files in parallel workers
    beside JAX's own threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run_fleet(pkg, runtime):
    """The 8 queries through a contended FleetScheduler with the oracle
    routed; returns (results, stats)."""
    prev = pkg.rt.set_runtime(runtime)
    try:
        videos = {n: pkg.video.Video(pkg.video.corpus(hours=HOURS)[n])
                  for n in CAMERAS}
        stores = {n: pkg.lm.build_landmarks(v, 30, pkg.det)
                  for n, v in videos.items()}
        banks = {n: pkg.training.FrameBank(v) for n, v in videos.items()}
        sched = pkg.fleet.FleetScheduler(contended=True)
        for i, (cam, kind, kw) in enumerate(SPECS):
            env = pkg.query.make_env(
                videos[cam], pkg.query.Query(kind, pkg.video.QUERY_CLASS[cam]),
                stores[cam], bank=banks[cam], train_steps=STEPS)
            ex = pkg.fleet.make_executor(env, full_family=False)
            if kind == "tagging":
                ex.levels = (30, 10, 1)
            sched.add(f"q{i}", cam, ex, priority=i % 2, weight=1.0 + i,
                      slo_s=5.0 if i == 0 else None, **kw)
        return sched.run(), sched.stats
    finally:
        pkg.rt.set_runtime(prev)


@pytest.fixture(scope="module")
def both_fleets():
    trained = []
    train = jops.train_operator

    def record(arch, params, crops, labels, counts, **kw):
        out = train(arch, params, crops, labels, counts, **kw)
        trained.append((arch.name, np.asarray(labels),
                        jax.tree_util.tree_map(np.asarray, out)))
        return out

    replayed = []

    def replay(arch, params, crops, labels, counts, **kw):
        name, want_labels, tree = trained[len(replayed)]
        assert name == arch.name, (name, arch.name)
        assert np.array_equal(np.asarray(labels), want_labels), name
        replayed.append(name)
        return tops.params_from_jax(tree, kw["device"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "train_operator", record)
        mp.setattr(tops, "train_operator", replay)
        want = _run_fleet(JAX, jrt.OperatorRuntime(backend="jnp"))
        got = _run_fleet(PORT, trt.OperatorRuntime(device="cpu"))
    assert replayed == [name for name, _, _ in trained] and trained
    return want, got


def _close(a, b, rel=0.01):
    return abs(a - b) <= rel * abs(b)


@pytest.mark.parametrize("qid", [f"q{i}" for i in range(len(SPECS))])
def test_contended_fleet_matches_jax_package(both_fleets, qid):
    """Each query: the same operator switches and final value;
    ``bytes_up``, ``done_t``, the switch times and ``time_to`` within 1%."""
    (jres, _), (tres, _) = both_fleets
    jprog, tprog = jres[qid], tres[qid]
    assert [n for _, n in tprog.op_switches] == \
        [n for _, n in jprog.op_switches]
    for (tt, _), (jt, _) in zip(tprog.op_switches, jprog.op_switches):
        assert _close(tt, jt)
    assert tprog.points and tprog.points[-1][1] == jprog.points[-1][1]
    assert _close(tprog.bytes_up, jprog.bytes_up)
    assert _close(tprog.done_t, jprog.done_t)
    for frac in (0.5, 0.9, 0.99):
        jt, tt = jprog.time_to(frac), tprog.time_to(frac)
        assert (jt is None) == (tt is None), frac
        if jt is not None:
            assert _close(tt, jt), frac


def test_contended_fleet_stats_match_jax_package(both_fleets):
    """The scheduler's and the routed oracle's accounting: every count
    equal, the queueing delays within 1%; verifications were routed and
    operators were shipped, so the comparison covered both."""
    (jres, jst), (tres, tst) = both_fleets
    for key in EXACT_STATS:
        assert tst[key] == jst[key], key
    for key in EXACT_ORACLE_STATS:
        assert tst["oracle"][key] == jst["oracle"][key], key
    jq, tq = jst["oracle"]["queue_delay_s"], tst["oracle"]["queue_delay_s"]
    assert set(tq) == set(jq)
    for p, want in jq.items():
        assert tq[p]["n"] == want["n"], p
        for stat in ("mean", "max"):
            assert abs(tq[p][stat] - want[stat]) <= 0.01 * want[stat] \
                + 1e-4, (p, stat)
    assert tst["verify_demands"] > 0 and tst["oracle"]["slots"] > 0
    assert any(p.op_switches for p in tres.values())


# -- OracleService admission, script by script --------------------------------


class _StubEnv:
    def cloud_verify(self, idx):
        return (idx % 2 == 0, idx % 3)


def _priority(svc_cls, demand, log):
    svc = svc_cls(slot_frames=4, eager=False)
    env = _StubEnv()
    svc.register("lo", env, priority=0)
    svc.register("hi", env, priority=5)
    for qid in ("lo", "hi"):
        for i in range(4):
            svc.submit(demand(i, "car", at=0.0, qid=qid))
    log(svc.step())
    log(svc.step())
    return svc


def _fair_share(svc_cls, demand, log):
    svc = svc_cls(slot_frames=4, eager=False)
    env = _StubEnv()
    svc.register("heavy", env, weight=1.0)
    svc.register("light", env, weight=4.0)
    for i in range(12):
        svc.submit(demand(i, "car", at=0.5 * i, qid="heavy"))
    log(svc.step())
    for i in range(6):
        svc.submit(demand(i, "car", at=1.0, qid="light"))
    while svc._heap:
        log(svc.step())
    return svc


def _slo(svc_cls, demand, log):
    svc = svc_cls(slot_frames=2, det_fps=10.0, eager=False)
    env = _StubEnv()
    svc.register("urgent", env, priority=0, slo_s=0.0)
    svc.register("vip", env, priority=9)
    for i in range(4):
        svc.submit(demand(i, "car", at=0.0, qid="vip"))
    svc.submit(demand(99, "car", at=0.0, qid="urgent"))
    for i in range(4, 7):
        svc.submit(demand(i, "car", at=0.1, qid="vip"))
    while svc._heap:
        log(svc.step())
    return svc


def _eager(svc_cls, demand, log):
    svc = svc_cls(slot_frames=3)
    env = _StubEnv()
    svc.register("q", env)
    tickets = [svc.submit(demand(i, "car", at=0.0, qid="q"))
               for i in range(7)]
    log([t for t in tickets if t.done])
    svc.complete(tickets[-1])
    log(tickets[-1:])
    return svc


SCRIPTS = {"priority": _priority, "fair_share": _fair_share, "slo": _slo,
           "eager": _eager}


def _drive(script, svc_cls, demand):
    slots = []
    svc = script(svc_cls, demand, lambda tickets: slots.append(
        [(t.demand.qid, t.demand.idx, t.result()) for t in tickets]))
    return slots, svc.stats()


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_oracle_service_admission_matches_jax_package(name):
    """The same slots, each with the same demands in the same order and
    the same answers, and the same ``stats()`` key for key."""
    want = _drive(SCRIPTS[name], joracle.OracleService,
                  jstepper.VerifyDemand)
    got = _drive(SCRIPTS[name], toracle.OracleService,
                 tstepper.VerifyDemand)
    assert want[0] and got[0] == want[0]
    assert got[1] == want[1]
