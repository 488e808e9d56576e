"""The port's Retrieval query on its own, training its own operators.

What ``tests/test_zc2_queries.py::test_retrieval_end_to_end`` asks of
the JAX package, asked of the port on 0.25 h of the Banff scene with the
reduced family, three ranking passes and 20 training steps, all on the
CPU (``device="cpu"``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import landmarks as lm  # noqa: E402
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.ranking import RetrievalExecutor  # noqa: E402
from repro_torch.core.runtime import OperatorRuntime, set_runtime  # noqa: E402
from repro_torch.core.video import Video, corpus  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """PyTorch's CPU kernels take one thread per core by default; the
    suite runs test files in parallel workers beside JAX's own threads,
    so one thread each keeps the host from being oversubscribed."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_port_retrieval_end_to_end():
    rt = OperatorRuntime(device="cpu")
    prev = set_runtime(rt)
    try:
        video = Video(corpus(hours=0.25)["Banff"])
        store = lm.build_landmarks(video, 30, YOLO_V3)
        env = make_env(video, Query("retrieval", "bus"), store,
                       train_steps=20)
        prog = RetrievalExecutor(env, full_family=False).run(max_passes=3)
    finally:
        set_runtime(prev)
    ts = [t for t, _ in prog.points]
    assert all(a <= b + 1e-9 for a, b in zip(ts, ts[1:])), "time monotone"
    assert prog.done_t is not None and prog.bytes_up > 0
    assert all(t <= prog.done_t + 1e-6 for t in ts)
    vs = [v for _, v in prog.points]
    assert all(a <= b for a, b in zip(vs, vs[1:])), "retrieval monotone"
    assert vs[-1] >= 0.99, "must eventually return ~all positives"
    assert prog.op_switches, "at least the initial operator must ship"
    t50, t99 = prog.time_to(0.5), prog.time_to(0.99)
    assert t50 is not None and t99 is not None
    assert t50 < 0.55 * t99
    # the operators were scored through the runtime, on the CPU
    assert rt.calls > 0 and rt.frames_scored > 0
