"""The slice as a whole: one Retrieval query in both packages.

0.25 h of the Banff scene, the reduced operator family, three ranking
passes, 20 training steps. The JAX package runs the query and records
every operator it trains, in call order; the port runs the same query
with ``train_operator`` replaced by a replay of those weights (carried
across with ``params_from_jax``), so both rank with the same operators
and any difference comes from the port's scoring path. Simulated time
comes from the same cost models, so switches, bytes and times agree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import landmarks as jlm  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core import ranking as jranking  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core import stepper as jstepper  # noqa: E402
from repro.core import video as jvideo  # noqa: E402
from repro.core.hardware import YOLO_V3 as J_YOLO_V3  # noqa: E402
from repro_torch.core import landmarks as tlm  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import query as tquery  # noqa: E402
from repro_torch.core import ranking as tranking  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import stepper as tstepper  # noqa: E402
from repro_torch.core import video as tvideo  # noqa: E402
from repro_torch.core.hardware import YOLO_V3 as T_YOLO_V3  # noqa: E402

HOURS, PASSES, STEPS = 0.25, 3, 20


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """PyTorch's CPU kernels take one thread per core by default; the
    suite runs test files in parallel workers beside JAX's own threads,
    so one thread each keeps the host from being oversubscribed."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Log:
    """Records what a query scored and the order it uploaded frames."""

    def __init__(self, session):
        self.session = session
        self.scored = []          # (idxs, probs) per ScoreDemand
        self.uploads = []         # frame index per VerifyDemand

    def score(self, d):
        probs, counts = self.session.score(d.trained, d.idxs)
        self.scored.append((np.asarray(d.idxs).copy(), probs.copy()))
        return probs, counts

    def verify(self, d):
        self.uploads.append(int(d.idx))
        return self.session.env.cloud_verify(d.idx)


def _run(pkg, runtime):
    """One query through package ``pkg`` = (video, landmarks, hardware
    detector, query, ranking, stepper, runtime modules)."""
    video_m, lm_m, det, query_m, ranking_m, stepper_m, rt_m = pkg
    prev = rt_m.set_runtime(runtime)
    try:
        video = video_m.Video(video_m.corpus(hours=HOURS)["Banff"])
        store = lm_m.build_landmarks(video, 30, det)
        env = query_m.make_env(video, query_m.Query("retrieval", "bus"),
                               store, train_steps=STEPS)
        ex = ranking_m.RetrievalExecutor(env, full_family=False)
        log = _Log(ex.session)
        prog = stepper_m.drive(ex.steps(PASSES), ex.session,
                               score=log.score, verify=log.verify)
    finally:
        rt_m.set_runtime(prev)
    return prog, log


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
        jprog, jlog = _run((jvideo, jlm, J_YOLO_V3, jquery, jranking,
                            jstepper, jrt),
                           jrt.OperatorRuntime(backend="jnp"))
        tprog, tlog = _run((tvideo, tlm, T_YOLO_V3, tquery, tranking,
                            tstepper, trt),
                           trt.OperatorRuntime(device="cpu"))
    assert replayed == [name for name, _ in trained]
    return jprog, jlog, tprog, tlog


def _close(a, b, rel=0.01):
    return abs(a - b) <= rel * abs(b)


def test_query_matches_jax_package(both_runs):
    jprog, _, tprog, _ = both_runs
    assert [n for _, n in tprog.op_switches] == \
        [n for _, n in jprog.op_switches]
    assert len(jprog.op_switches) >= 2          # the query upgraded once
    assert tprog.points[-1][1] == jprog.points[-1][1]
    assert _close(tprog.bytes_up, jprog.bytes_up)
    assert _close(tprog.done_t, jprog.done_t)
    for frac in (0.5, 0.9, 0.99):
        assert _close(tprog.time_to(frac), jprog.time_to(frac)), frac


def test_scores_and_upload_order_match_jax_package(both_runs):
    """Every ranking pass scores the same frames, each within 1e-5 of
    the JAX package's score. Orders (of a pass, and of the uploads) are
    the same except where two frames' scores tie within 1e-5, where the
    float32 summation order may swap them: on this input one such pair
    swaps in the second pass and again in the uploads."""
    _, jlog, _, tlog = both_runs
    assert len(tlog.scored) == len(jlog.scored) >= 2

    def tied(a, b, scores):
        return abs(scores.get(a, np.nan) - scores.get(b, np.nan)) <= 1e-5

    last = {}                  # frame -> its latest score so far
    for (ti, tp), (ji, jp) in zip(tlog.scored, jlog.scored):
        ti, ji = ti.tolist(), ji.tolist()
        assert sorted(ti) == sorted(ji)
        # a pass's order comes from the scores of the passes before it
        assert all(tied(a, b, last) for a, b in zip(ti, ji) if a != b)
        mine = dict(zip(ti, tp.tolist()))
        np.testing.assert_allclose([mine[i] for i in ji], jp, rtol=0,
                                   atol=1e-5)
        last.update(zip(ji, jp.tolist()))
    assert len(tlog.uploads) == len(jlog.uploads)
    swaps = [(a, b) for a, b in zip(tlog.uploads, jlog.uploads) if a != b]
    assert all(tied(a, b, last) for a, b in swaps), swaps
    assert len(swaps) <= 0.01 * len(jlog.uploads)
