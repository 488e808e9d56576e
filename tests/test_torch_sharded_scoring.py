"""Device-parallel scoring in the port: a fleet over a scoring mesh of
repeated CPU slots, bit for bit the unsharded fleet.

The port's counterpart of ``tests/test_sharded_scoring.py`` and
``tests/_sharded_subprocess.py``: where the JAX package forces 4 host
devices, the port names the CPU four times
(``make_scoring_mesh(["cpu"] * 4)``), each entry one slot of the data
axis, so the split code runs here as it runs over cards. Checked: the
fleet's every Progress, its dispatch count and its traces per arch
against the unsharded fleet (and on 2 slots, where its group of 2
splits); superbatch groups of 4 (split) and 5 (run whole on slot 0, the
one fallback recorded) bit for bit per-demand scoring; ``score_crops``
through the small and bucketed layers bit for bit with and without
``shard_frames``. Everything runs on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import landmarks as lm_mod  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.fleet import (FleetScheduler,  # noqa: E402
                                    device_aware_group_max, make_executor)
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.runtime import (OperatorRuntime, TraceGuard,  # noqa: E402
                                      set_runtime)
from repro_torch.core.training import FrameBank  # noqa: E402
from repro_torch.core.video import QUERY_CLASS, Video, corpus  # noqa: E402
from repro_torch.launch.mesh import make_scoring_mesh  # noqa: E402
from repro_torch.serving.fleet import FleetService  # noqa: E402

HOURS, STEPS = 0.05, 3
CAMERAS = ("JacksonH", "Banff")
# Retrieval and MaxCount (scoring) with an operator-free sampler, so the
# run takes the superbatch, bucketed and small layers
SPECS = [("JacksonH", "retrieval", {"max_passes": 2}),
         ("JacksonH", "retrieval", {"max_passes": 2}),
         ("JacksonH", "retrieval", {"max_passes": 1}),
         ("JacksonH", "retrieval", {"max_passes": 1}),
         ("Banff", "retrieval", {"max_passes": 2}),
         ("Banff", "count_max", {"max_passes": 2}),
         ("Banff", "count_avg", {})]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _progress(p):
    return (p.points, p.bytes_up, p.done_t, p.op_switches)


@pytest.fixture(scope="module")
def fleets():
    videos = {n: Video(corpus(hours=HOURS)[n]) for n in CAMERAS}
    stores = {n: lm_mod.build_landmarks(v, 30, YOLO_V3)
              for n, v in videos.items()}

    def run(mesh):
        banks = {n: FrameBank(v) for n, v in videos.items()}
        # the queries train their operators on a CPU runtime of their own
        prev = set_runtime(OperatorRuntime(device="cpu"))
        try:
            rt = OperatorRuntime(device="cpu", mesh=mesh)
            sched = FleetScheduler(contended=False, runtime=rt,
                                   group_max=8)
            for i, (cam, kind, kw) in enumerate(SPECS):
                env = make_env(videos[cam], Query(kind, QUERY_CLASS[cam]),
                               stores[cam], bank=banks[cam],
                               train_steps=STEPS)
                sched.add(f"q{i}", cam, make_executor(env), **kw)
            with TraceGuard(rt) as guard:
                res = sched.run()
        finally:
            set_runtime(prev)
        return res, sched, guard, rt

    return {n: run(make_scoring_mesh(["cpu"] * n) if n > 1 else None)
            for n in (1, 4, 2)}


@pytest.mark.parametrize("slots", [4, 2])
def test_sharded_fleet_is_the_unsharded_fleet_bit_for_bit(fleets, slots):
    res, sched, guard, rt = fleets[1]
    sres, ssched, sguard, srt = fleets[slots]
    assert set(sres) == set(res) == {f"q{i}" for i in range(len(SPECS))}
    for qid, prog in res.items():
        assert _progress(sres[qid]) == _progress(prog), qid
    assert ssched.stats["dispatches"] == sched.stats["dispatches"]
    assert sguard.traces_per_arch == guard.traces_per_arch
    assert srt.dispatch_stats() == rt.dispatch_stats()
    assert ssched.stats["sharded"] and ssched.stats["device_count"] == slots
    assert ssched.stats["mesh_shape"] == {"data": slots}
    assert not sched.stats["sharded"] and sched.stats["device_count"] == 1
    assert rt.super_calls > 0
    # the fleet's group of 2 runs whole on 4 slots (recorded) and splits
    # over 2 (every slot scored a part)
    if slots == 4:
        assert srt.sharding_fallbacks() == [
            {"axis": "group", "mesh_axes": ["data"], "count": 1,
             "dims": [2]}]
        assert all(v[1:] == [0, 0, 0] for v in srt.slot_parts.values())
    else:
        assert srt.sharding_fallbacks() == []
        assert srt.slot_parts["super"] == [rt.super_calls] * 2


class _Trained:
    def __init__(self, arch, params):
        self.arch, self.params = arch, params


class _Bank:
    def __init__(self, crops):
        self._c = crops

    def crops(self, idxs, region, size):
        return self._c[np.asarray(idxs)]


def test_superbatch_groups_split_bit_for_bit():
    """A group of 4 splits one member a slot, a group of 5 runs whole on
    slot 0; each member's result is its per-demand scoring's bits, and
    the fallback record is exactly the group of 5."""
    mesh = make_scoring_mesh(["cpu"] * 4)
    rng = np.random.default_rng(7)
    rt = OperatorRuntime(device="cpu", mesh=mesh)
    for g in (4, 5):
        demands = []
        for k in range(g):
            a = ops.OperatorArch(f"g{k}", 3, 16, 32, 50)
            p = ops.init_operator(a, torch.Generator().manual_seed(100 + k),
                                  "cpu")
            c = rng.uniform(size=(300, 50, 50, 3)).astype(np.float32)
            demands.append((_Trained(a, p), _Bank(c), np.arange(300)))
        want = [OperatorRuntime(device="cpu").score_crops(t.params, t.arch,
                                                          b._c)
                for t, b, _ in demands]
        parts = list(rt.slot_parts["super"])
        got = rt.score_demands(demands, group_max=g)
        for (wp, wc), (gp, gc) in zip(want, got):
            assert np.array_equal(wp, gp) and np.array_equal(wc, gc), g
        split = [b - a for a, b in zip(parts, rt.slot_parts["super"])]
        assert split == ([1, 1, 1, 1] if g == 4 else [1, 0, 0, 0])
    assert [(e["axis"], e["dims"]) for e in rt.sharding_fallbacks()] == \
        [("group", [5])]
    assert rt.super_calls == 2
    assert rt.mesh_info() == {"device_count": 4, "mesh_shape": {"data": 4},
                              "sharded": True}


@pytest.mark.parametrize("n", [96, 200, 1500])
def test_score_crops_bit_for_bit_with_and_without_shard_frames(n):
    """96 frames (small layer), 200 (bucketed, padded to 256) and 1500
    (1024 and 476 -> 512): the plain runtime, the mesh runtime (flat
    batches stay on slot 0) and the frame-split one give the same bits."""
    arch = ops.OperatorArch("shard_probe", 3, 16, 32, 50)
    params = ops.init_operator(arch, torch.Generator().manual_seed(7), "cpu")
    crops = np.random.default_rng(n).uniform(
        size=(n, 50, 50, 3)).astype(np.float32)
    mesh = make_scoring_mesh(["cpu"] * 4)
    plain = OperatorRuntime(device="cpu")
    whole = OperatorRuntime(device="cpu", mesh=mesh)
    split = OperatorRuntime(device="cpu", mesh=mesh, shard_frames=True)
    pw, cw = plain.score_crops(params, arch, crops)
    for rt in (whole, split):
        pg, cg = rt.score_crops(params, arch, crops)
        assert np.array_equal(pw, pg) and np.array_equal(cw, cg)
        assert rt.calls == plain.calls
    for kind in ("small", "bucketed"):
        assert whole.slot_parts[kind][1:] == [0, 0, 0]
        assert split.slot_parts[kind] == [getattr(plain, kind + "_calls")] * 4
    assert split.sharding_fallbacks() == []


def test_mesh_value_and_group_watermark():
    """One slot or none is no mesh; a device may repeat; the fleet's
    default watermark is a multiple of the slots; FleetService passes its
    mesh to the scheduler, which scores through a mesh runtime."""
    assert make_scoring_mesh(["cpu"]) is None
    assert make_scoring_mesh([]) is None
    mesh = make_scoring_mesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.axis_names == ("data",)
    assert mesh.shape == {"data": 3} and mesh.devices[0] == torch.device("cpu")
    assert device_aware_group_max(None) == 8
    assert device_aware_group_max(mesh) == 9
    assert device_aware_group_max(make_scoring_mesh(["cpu"] * 4)) == 8
    assert FleetScheduler(mesh=mesh).group_max == 9
    rt = OperatorRuntime(device="cpu", mesh=mesh)
    assert rt.device == torch.device("cpu") and rt.device_count == 3
    sched = FleetScheduler(mesh=mesh, oracle=False)
    assert sched.runtime.mesh is mesh and sched.runtime is sched.runtime
    svc = FleetService(mesh=mesh)
    assert svc.mesh is mesh
