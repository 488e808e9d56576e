"""The port's text-query example against the JAX package's, on the CPU.

``examples/torch_zc2_text_query.py`` (its scorer in PyTorch, the port's
``core/queue`` and ``core/upgrade``) and ``examples/zc2_text_query.py``
(NumPy, the JAX package's modules) on the same small corpus from the
same seed: the same corpus, scores within 1e-12 of each other (float64
on both sides; the histograms are exact), and the same query, line for
line (every retrieval time, the upload count), all but the host's wall
time.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
N_DOCS = 600                 # of the examples' 3,000
SCORE_TOL = 1e-12


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mods = _load("zc2_text_query"), _load("torch_zc2_text_query")
    for m in mods:
        m.N_DOCS = N_DOCS
    yield mods
    torch.set_num_threads(n)


def test_text_query_matches_the_jax_example(examples, capsys):
    jex, tex = examples
    docs, gt = tex.make_corpus(3)
    jdocs, jgt = jex.make_corpus(3)
    assert np.array_equal(docs, jdocs) and np.array_equal(gt, jgt)
    idx = np.arange(0, N_DOCS, 30)
    labels = np.array([tex.oracle(docs[i]) for i in idx])
    assert labels.tolist() == [jex.oracle(docs[i]) for i in idx]
    for sub in (32, None):
        t = tex.HistScorer(sub, 100.0, seed=1, device="cpu")
        j = jex.HistScorer(sub, 100.0, seed=1)
        t.fit(docs[idx], labels)
        j.fit(docs[idx], labels)
        got, want = t.score(docs), j.score(docs)
        assert got.dtype == np.float64
        assert np.max(np.abs(got - want)) <= SCORE_TOL
    jex.main()
    want = capsys.readouterr().out.splitlines()
    tex.main("cpu")
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1] and len(got) == len(want) > 5
    assert got[-1].startswith("(host wall time")
