"""The port's shared verification service: a fleet that routes every
VerifyDemand through ``OracleService`` equals one that verifies inline,
bit for bit, contended or not; detect mode answers as the cached ground
truth; slot admission orders by priority, weighted fair share and SLO
deadlines (``tests/test_oracle_service.py``'s cases, on the port). The
workload runs at 0.1 h per camera and 5 training steps on the CPU
(``device="cpu"``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import landmarks as lm_mod  # noqa: E402
from repro_torch.core.fleet import FleetScheduler, make_executor  # noqa: E402
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.runtime import OperatorRuntime, set_runtime  # noqa: E402
from repro_torch.core.stepper import VerifyDemand  # noqa: E402
from repro_torch.core.training import FrameBank  # noqa: E402
from repro_torch.core.video import QUERY_CLASS, Video, corpus  # noqa: E402
from repro_torch.serving.oracle_service import OracleService  # noqa: E402

HOURS, STEPS = 0.1, 5
CAMERAS = ("Banff", "Miami")
# verify-heavy mix (tests/test_oracle_service.py's WORKLOAD)
WORKLOAD = [
    ("Banff", "retrieval", {"max_passes": 2}),
    ("Banff", "count_avg", {}),
    ("Miami", "count_median", {}),
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One torch thread: the suite runs test files in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    videos = {n: Video(corpus(hours=HOURS)[n]) for n in CAMERAS}
    stores = {n: lm_mod.build_landmarks(v, 30, YOLO_V3)
              for n, v in videos.items()}
    banks = {n: FrameBank(v) for n, v in videos.items()}
    return videos, stores, banks


def _executor(world, cam, kind):
    videos, stores, banks = world
    env = make_env(videos[cam], Query(kind, QUERY_CLASS[cam]), stores[cam],
                   bank=banks[cam], train_steps=STEPS)
    return make_executor(env, full_family=False)


def _run_routed(world, *, oracle, contended):
    prev = set_runtime(OperatorRuntime(device="cpu"))
    try:
        sched = FleetScheduler(contended=contended, oracle=oracle)
        for i, (cam, kind, kw) in enumerate(WORKLOAD):
            sched.add(f"q{i}", cam, _executor(world, cam, kind),
                      priority=i % 2, weight=1.0 + i,
                      slo_s=None if i else 5.0, **kw)
        return sched.run(), sched
    finally:
        set_runtime(prev)


@pytest.fixture(scope="module")
def inline_vs_routed(world):
    return {contended: (_run_routed(world, oracle=False,
                                    contended=contended)[0],
                        *_run_routed(world, oracle=None,
                                     contended=contended))
            for contended in (False, True)}


@pytest.mark.parametrize("contended", [False, True])
def test_routed_fleet_bitwise_equals_inline(inline_vs_routed, contended):
    inline, routed, sched = inline_vs_routed[contended]
    assert set(inline) == set(routed) == {f"q{i}"
                                          for i in range(len(WORKLOAD))}
    for qid in inline:
        assert routed[qid].points == inline[qid].points
        assert routed[qid].bytes_up == inline[qid].bytes_up
        assert routed[qid].done_t == inline[qid].done_t
        assert routed[qid].op_switches == inline[qid].op_switches
    st = sched.stats
    assert st["oracle"]["frames_verified"] == st["verify_demands"] > 0
    delayed = sum(d["n"] for d in st["oracle"]["queue_delay_s"].values())
    assert delayed == st["verify_demands"]


class _StubEnv:
    def cloud_verify(self, idx):
        return (idx % 2 == 0, idx % 3)


def test_priority_orders_slot_admission():
    svc = OracleService(slot_frames=4, eager=False)
    env = _StubEnv()
    svc.register("lo", env, priority=0)
    svc.register("hi", env, priority=5)
    lo = [svc.submit(VerifyDemand(i, "car", at=0.0, qid="lo"))
          for i in range(4)]
    hi = [svc.submit(VerifyDemand(i, "car", at=0.0, qid="hi"))
          for i in range(4)]
    assert [t.demand.qid for t in svc.step()] == ["hi"] * 4
    assert [t.demand.qid for t in svc.step()] == ["lo"] * 4
    assert all(t.done for t in lo + hi)
    assert lo[0].result() == env.cloud_verify(0)


def test_weighted_fair_share_prevents_starvation():
    svc = OracleService(slot_frames=4, eager=False)
    env = _StubEnv()
    svc.register("heavy", env, weight=1.0)
    svc.register("light", env, weight=1.0)
    for i in range(12):
        svc.submit(VerifyDemand(i, "car", at=0.0, qid="heavy"))
    svc.step()
    light = [svc.submit(VerifyDemand(i, "car", at=0.0, qid="light"))
             for i in range(2)]
    assert {t.demand.qid for t in svc.step()} == {"heavy", "light"}
    assert all(t.done for t in light)
    svc.flush()
    st = svc.stats()
    assert st["per_qid"]["light"]["max_slots_waited"] <= 1
    assert st["per_qid"]["heavy"]["served"] == 12


def test_slo_deadline_preempts_priority():
    svc = OracleService(slot_frames=2, det_fps=10.0, eager=False)
    env = _StubEnv()
    svc.register("urgent", env, priority=0, slo_s=0.0)
    svc.register("vip", env, priority=9)
    for i in range(4):
        svc.submit(VerifyDemand(i, "car", at=0.0, qid="vip"))
    svc.submit(VerifyDemand(99, "car", at=0.0, qid="urgent"))
    assert "urgent" in {t.demand.qid for t in svc.step()}
    svc.flush()
    st = svc.stats()
    assert st["queue_delay_s"][9]["max"] > 0.0
    assert st["overdue_bumped"] >= 0


def test_eager_slot_fires_at_capacity():
    svc = OracleService(slot_frames=3)
    env = _StubEnv()
    svc.register("q", env)
    tickets = [svc.submit(VerifyDemand(i, "car", at=0.0, qid="q"))
               for i in range(7)]
    assert [t.done for t in tickets] == [True] * 6 + [False]
    assert svc.stats()["occupancy_mean"] == 3.0
    assert svc.complete(tickets[-1]) == env.cloud_verify(6)
    with pytest.raises(ValueError, match="not registered"):
        svc.submit(VerifyDemand(0, "car", qid="nope"))


def test_detect_mode_matches_cached_ground_truth(world):
    """compute="detect" reruns the seeded oracle detector: the same
    answers as the env's cached arrays, shared frames detected once."""
    videos, stores, banks = world
    env = make_env(videos["Banff"], Query("retrieval", QUERY_CLASS["Banff"]),
                   stores["Banff"], bank=banks["Banff"], train_steps=STEPS)
    env2 = make_env(videos["Banff"], Query("count_max", QUERY_CLASS["Banff"]),
                    stores["Banff"], bank=banks["Banff"], train_steps=STEPS)
    svc = OracleService(slot_frames=4, compute="detect", eager=False)
    svc.register("a", env)
    svc.register("b", env2)
    idxs = [int(i) for i in env.frames[:6]]
    tickets = [svc.submit(VerifyDemand(i, env.query.cls, at=0.0, qid="a"))
               for i in idxs]
    dups = [svc.submit(VerifyDemand(i, env2.query.cls, at=0.0, qid="b"))
            for i in idxs[:3]]
    svc.flush()
    assert [t.result() for t in tickets] == [env.cloud_verify(i)
                                             for i in idxs]
    assert [t.result() for t in dups] == [env2.cloud_verify(i)
                                          for i in idxs[:3]]
    st = svc.stats()
    assert st["detect_calls"] == len(idxs) and st["dedup_hits"] == 3
