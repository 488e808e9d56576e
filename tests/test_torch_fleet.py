"""The port's multi-query path: FleetScheduler and FleetService, held
to the port's own standalone runs.

An uncontended fleet must give every query the Progress its standalone
run gives, bit for bit, with fewer dispatches (the stacked superbatch)
and no retrace. With ``tests/test_torch_executors.py`` and
``tests/test_torch_query.py`` (the port's standalone executors against
the JAX package's) this closes the chain from the port's fleet to the
JAX package's fleet; ``tests/test_torch_oracle_service.py`` holds the
routed verification to the inline one. The workload is
``tests/test_fleet.py``'s at 0.1 h per camera and 5 training steps (the
equality does not depend on how well an operator is trained); everything
runs on the CPU (``device="cpu"``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import landmarks as lm_mod  # noqa: E402
from repro_torch.core.fleet import FleetScheduler, make_executor  # noqa: E402
from repro_torch.core.hardware import YOLO_V3, NetworkModel  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.runtime import (OperatorRuntime, TraceGuard,  # noqa: E402
                                      get_runtime, set_runtime)
from repro_torch.core.training import FrameBank  # noqa: E402
from repro_torch.core.video import QUERY_CLASS, Video, corpus  # noqa: E402
from repro_torch.serving.fleet import FleetService  # noqa: E402

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


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One torch thread: the suite runs test files in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _cpu_runtime():
    """The process-global runtime on the CPU for the tests that use it
    (the port's default is the card)."""
    prev = set_runtime(OperatorRuntime(device="cpu"))
    yield
    set_runtime(prev)


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
    ex = make_executor(env, full_family=False)
    if kind == "tagging":
        ex.levels = (30, 10, 1)
    return ex


@pytest.fixture(scope="module")
def fleet_vs_solo(world):
    """The 8-query workload standalone, then through an uncontended
    FleetScheduler, each on a fresh CPU runtime."""
    prev = set_runtime(OperatorRuntime(device="cpu"))
    try:
        solo, solo_calls = [], 0
        for cam, kind, kw in SPECS:
            c0 = get_runtime().calls
            solo.append(_executor(world, cam, kind).run(**kw))
            solo_calls += get_runtime().calls - c0
    finally:
        set_runtime(prev)
    rt = OperatorRuntime(device="cpu")
    prev = set_runtime(rt)
    try:
        sched = FleetScheduler(contended=False)
        for i, (cam, kind, kw) in enumerate(SPECS):
            sched.add(f"q{i}", cam, _executor(world, cam, kind), **kw)
        with TraceGuard(rt) as guard:
            fleet = sched.run()
    finally:
        set_runtime(prev)
    return solo, fleet, solo_calls, sched, guard, rt


def test_fleet_matches_standalone_bitwise(fleet_vs_solo):
    solo, fleet, _, sched, _, _ = fleet_vs_solo
    assert len(fleet) == len(SPECS) and sched.stats["cameras"] == 3
    for i, standalone in enumerate(solo):
        mine = fleet[f"q{i}"]
        assert mine.points == standalone.points, i
        assert mine.bytes_up == standalone.bytes_up, i
        assert mine.done_t == standalone.done_t, i
        assert mine.op_switches == standalone.op_switches, i
    assert any(p.op_switches for p in solo)


def test_fleet_batches_scoring_into_fewer_dispatches(fleet_vs_solo):
    """Fewer dispatches than the standalone runs, at least one of them a
    stacked superbatch, over the same frames."""
    _, _, solo_calls, sched, _, rt = fleet_vs_solo
    assert sched.stats["dispatches"] < solo_calls
    assert sched.stats["frames_scored"] > 0
    assert rt.dispatch_stats()["super_calls"] > 0
    assert rt._group_traces


def test_fleet_traces_each_shape_once(fleet_vs_solo):
    _, _, _, _, guard, rt = fleet_vs_solo
    guard.check()
    assert guard.traces_per_arch
    assert all(n == 1 for n in guard.new_traces.values())
    assert rt.n_compiled >= len(guard.traces_per_arch)


def test_fleet_eager_dispatch_fires_on_mixed_arch_workload(fleet_vs_solo):
    """The bucket-complete watermark fires on the mixed-arch fleet, and
    the stats report one device, unsharded."""
    _, _, _, sched, _, _ = fleet_vs_solo
    fires = sched.stats["watermark_fires"]
    assert sched.stats["eager_dispatches"] > 0, fires
    assert fires["bucket_complete"] > 0
    assert sched.stats["overlap_host_s"] >= 0.0
    assert sched.stats["device_count"] == 1
    assert sched.stats["sharded"] is False


def test_contention_slows_a_shared_camera(world):
    """Two sampling counters on one camera finish later when they share
    its uplink, upload the same values, and do not depend on the order
    they were added in."""
    def run_pair(contended, reverse=False):
        sched = FleetScheduler(contended=contended)
        kinds = [(0, "count_avg"), (1, "count_median")]
        for i, kind in (reversed(kinds) if reverse else kinds):
            sched.add(f"c{i}", "Banff", _executor(world, "Banff", kind))
        return sched.run()

    alone = [_executor(world, "Banff", k).run()
             for k in ("count_avg", "count_median")]
    shared, free = run_pair(True), run_pair(False)
    swapped = run_pair(True, reverse=True)
    for i in range(2):
        assert free[f"c{i}"].done_t == alone[i].done_t
        assert shared[f"c{i}"].done_t > alone[i].done_t
        assert [v for _, v in shared[f"c{i}"].points] == \
            [v for _, v in alone[i].points]
        assert swapped[f"c{i}"].done_t == shared[f"c{i}"].done_t


def test_fleet_service_streams_progress(world):
    videos, stores, _ = world
    svc = FleetService(contended=True, train_steps=STEPS)
    for name in ("Banff", "Miami"):
        svc.register_camera(name, videos[name], stores[name])
    q0 = svc.submit("Banff", Query("count_avg", QUERY_CLASS["Banff"]))
    q1 = svc.submit("Miami", Query("count_median", QUERY_CLASS["Miami"]),
                    net=NetworkModel(uplink_bytes_per_s=5e5))
    streamed = {}
    results = svc.run(on_progress=lambda qid, t, v: streamed.setdefault(
        qid, []).append((t, v)))
    assert set(results) == {q0, q1}
    for qid in (q0, q1):
        prog = svc.result(qid)
        assert prog is svc.progress(qid) and prog.done_t is not None
        assert streamed[qid] == prog.points


def test_mesh_raises():
    """A scoring mesh runs on its slot 0: a runtime asked for another
    device raises rather than scoring somewhere else; the scheduler and
    the service take the mesh (``tests/test_torch_sharded_scoring.py``
    holds the sharded fleet to this one)."""
    from repro_torch.launch.mesh import make_scoring_mesh
    mesh = make_scoring_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="slot 0"):
        OperatorRuntime(device="meta", mesh=mesh)
    assert FleetScheduler(mesh=mesh).runtime.mesh is mesh
    assert FleetService(mesh=mesh).mesh is mesh
