"""The main path's other executors in both packages: Tagging, both
Counting kinds and the three baselines (PreIndex, OptOp, cloud-only).

0.25 h of the Banff scene, the reduced operator family, 20 training
steps. The JAX package runs every case and records each operator it
trains, in call order; the port runs the same cases with
``train_operator`` replaced by a replay of those weights (carried
across with ``params_from_jax``), so both decide with the same operators
and any difference comes from the port's scoring path. Simulated time
comes from the same cost models, so switches, bytes and times agree.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.core import filtering as jfilt  # noqa: E402
from repro.core import landmarks as jlm  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core import video as jvideo  # noqa: E402
from repro.core.hardware import YOLO_V3 as J_YOLO_V3  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import filtering as tfilt  # noqa: E402
from repro_torch.core import landmarks as tlm  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import video as tvideo  # noqa: E402
from repro_torch.core.hardware import YOLO_V3 as T_YOLO_V3  # noqa: E402

HOURS, STEPS, CAMERA = 0.25, 20, "Banff"
LEVELS = (30, 10, 1)

JAX = types.SimpleNamespace(video=jvideo, lm=jlm, det=J_YOLO_V3,
                            query=jquery, rt=jrt, filt=jfilt, count=jcount,
                            base=jbase)
PORT = types.SimpleNamespace(video=tvideo, lm=tlm, det=T_YOLO_V3,
                             query=tquery, rt=trt, filt=tfilt, count=tcount,
                             base=tbase)


def _tagging(pkg, env):
    ex = pkg.filt.TaggingExecutor(env, full_family=False, levels=LEVELS)
    prog = ex.run()
    return prog, pkg.filt.tag_accuracy(env, ex.tags)


# name -> (query kind, error budget, run(pkg, env) -> (Progress, extra))
CASES = {
    "tagging": ("tagging", 0.05, _tagging),
    "count_max": ("count_max", 0.01, lambda pkg, env: (
        pkg.count.MaxCountExecutor(env, full_family=False).run(
            max_passes=2), None)),
    "count_mean": ("count_avg", 0.01, lambda pkg, env: (
        pkg.count.SampleCountExecutor(env, stat="mean").run(), None)),
    "count_median": ("count_median", 0.01, lambda pkg, env: (
        pkg.count.SampleCountExecutor(env, stat="median").run(), None)),
    "preindex_retrieval": ("retrieval", 0.01, lambda pkg, env: (
        pkg.base.preindex_retrieval(env), None)),
    "preindex_tagging": ("tagging", 0.05, lambda pkg, env: (
        pkg.base.preindex_tagging(env, levels=LEVELS), None)),
    "preindex_count": ("count_avg", 0.01, lambda pkg, env: (
        pkg.base.preindex_count(env, stat="mean"), None)),
    "optop_retrieval": ("retrieval", 0.01, lambda pkg, env: (
        pkg.base.optop_retrieval(env, full_family=False), None)),
    "optop_tagging": ("tagging", 0.05, lambda pkg, env: (
        pkg.base.optop_tagging(env, full_family=False, levels=LEVELS),
        None)),
    "cloud_only_retrieval": ("retrieval", 0.01, lambda pkg, env: (
        pkg.base.cloud_only_retrieval(env), None)),
    "cloud_only_tagging": ("tagging", 0.05, lambda pkg, env: (
        pkg.base.cloud_only_tagging(env, levels=LEVELS), None)),
    "cloud_only_count": ("count_median", 0.01, lambda pkg, env: (
        pkg.base.cloud_only_count(env, stat="median"), None)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One torch thread: the suite runs test files in parallel workers
    beside JAX's own threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run_all(pkg, runtime):
    """Every case through package ``pkg``, each on a fresh env."""
    prev = pkg.rt.set_runtime(runtime)
    try:
        video = pkg.video.Video(pkg.video.corpus(hours=HOURS)[CAMERA])
        store = pkg.lm.build_landmarks(video, 30, pkg.det)
        out = {}
        for name, (kind, budget, run) in CASES.items():
            env = pkg.query.make_env(
                video, pkg.query.Query(kind, pkg.video.QUERY_CLASS[CAMERA],
                                       error_budget=budget),
                store, train_steps=STEPS)
            out[name] = run(pkg, env)
    finally:
        pkg.rt.set_runtime(prev)
    return out


@pytest.fixture(scope="module")
def both_runs():
    trained = []
    train = jops.train_operator

    def record(arch, *args, **kw):
        params = train(arch, *args, **kw)
        trained.append((arch.name,
                        jax.tree_util.tree_map(np.asarray, params)))
        return params

    replayed = []

    def replay(arch, params, crops, labels, counts, **kw):
        name, tree = trained[len(replayed)]
        assert name == arch.name, (name, arch.name)
        replayed.append(name)
        return tops.params_from_jax(tree, kw["device"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "train_operator", record)
        mp.setattr(tops, "train_operator", replay)
        want = _run_all(JAX, jrt.OperatorRuntime(backend="jnp"))
        got = _run_all(PORT, trt.OperatorRuntime(device="cpu"))
    assert replayed == [name for name, _ in trained] and trained
    return want, got


def _close(a, b, rel=0.01):
    return abs(a - b) <= rel * abs(b)


@pytest.mark.parametrize("name", list(CASES))
def test_executor_matches_jax_package(both_runs, name):
    """The same operator switches; ``bytes_up``, ``done_t`` and
    ``time_to`` within 1%; the same final value."""
    (jprog, jextra), (tprog, textra) = (r[name] for r in both_runs)
    assert [n for _, n in tprog.op_switches] == \
        [n for _, n in jprog.op_switches]
    assert tprog.points and tprog.points[-1][1] == jprog.points[-1][1]
    assert _close(tprog.bytes_up, jprog.bytes_up)
    assert _close(tprog.done_t, jprog.done_t)
    for frac in (0.5, 0.9, 0.99):
        jt, tt = jprog.time_to(frac), tprog.time_to(frac)
        assert (jt is None) == (tt is None), frac
        if jt is not None:
            assert _close(tt, jt), frac
    if name == "tagging":
        for key, value in jextra.items():
            assert abs(textra[key] - value) <= 0.01, (key, textra, jextra)


def test_operator_executors_trained_and_switched(both_runs):
    """The cases that rank or tag with operators shipped at least one, so
    the parity above covered the port's scoring path."""
    _, got = both_runs
    for name in ("tagging", "count_max", "optop_retrieval",
                 "optop_tagging"):
        assert got[name][0].op_switches, name
