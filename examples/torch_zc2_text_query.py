"""Beyond-paper: the ZC2 engine over a *token* corpus, on the port.

The counterpart of ``examples/zc2_text_query.py`` (the JAX package's):
the paper's structure (cheap proxy scorers upgraded online, an
expensive oracle validating uploads, online partial results) over a
storage node holding 3,000 token documents; the query is "retrieve
documents about topic X".

    PYTHONPATH=src python examples/torch_zc2_text_query.py
    PYTHONPATH=src python examples/torch_zc2_text_query.py --device cpu

Reused ZC2 machinery of the port (not a re-implementation):
  * ``core/queue.AsyncUploadQueue`` — ranked, causally correct uploads
  * ``core/upgrade.ALPHA``, ``K_DECLINE`` and ``quality_declined`` — the
    paper's upgrade policy
  * the landmark idea — an oracle-labelled sparse sample (1-in-30
    documents) bootstraps proxy training, as video landmarks do
  * a trained scorer in PyTorch (``HistScorer``) — logistic regression
    on token histograms, trained online on cloud-verified labels; the
    cheap operator reads 32 tokens a document ("span cropping", the text
    analogue of the paper's spatial-skew cropping). It runs on the card
    unless ``--device cpu`` is given, in float64: a token histogram
    (integer counts over a power-of-two length) is exact, and the
    scores are the JAX example's NumPy scorer's within rounding.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.queue import AsyncUploadQueue  # noqa: E402
from repro_torch.core.upgrade import (ALPHA, K_DECLINE,  # noqa: E402
                                      quality_declined)
from repro_torch.kernels.ops import resolve_device  # noqa: E402

VOCAB = 512
TOPIC_BAND = (400, 440)     # topic-X docs over-use this token band
N_DOCS, DOC_LEN = 3_000, 512
UPLINK_DOCS_PER_S = 20.0    # network model: docs/s


def make_corpus(seed=0):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, 400, size=(N_DOCS, DOC_LEN)).astype(np.int32)
    labels = rng.uniform(size=N_DOCS) < 0.15
    for i in np.nonzero(labels)[0]:
        # topic docs: 4-10% of tokens drawn from the topic band
        k = int(DOC_LEN * rng.uniform(0.04, 0.10))
        pos = rng.choice(DOC_LEN, k, replace=False)
        docs[i, pos] = rng.integers(*TOPIC_BAND, size=k)
    return docs, labels


def oracle(doc) -> bool:
    """Cloud-side authoritative classifier (the 'YOLOv3' of this query)."""
    frac = np.mean((doc >= TOPIC_BAND[0]) & (doc < TOPIC_BAND[1]))
    return bool(frac > 0.02)


class HistScorer:
    """Trained proxy operator: logistic regression on token histograms,
    in PyTorch on ``device``. ``subsample``: tokens examined per doc, the
    cost/accuracy knob (the text analogue of the paper's input-crop
    sizes); which tokens a call examines is drawn from a NumPy generator
    seeded ``seed``, as the JAX example draws them."""

    def __init__(self, subsample, docs_per_s, seed=0, device=None):
        self.subsample = subsample
        self.fps = docs_per_s
        self.device = resolve_device(device)
        f64 = dict(dtype=torch.float64, device=self.device)
        self.w = torch.zeros(VOCAB, **f64)
        self.b = torch.zeros((), **f64)
        self.rng = np.random.default_rng(seed)

    def _feats(self, docs) -> torch.Tensor:
        """(n, VOCAB) float64: each token's share of the examined ones,
        from integer counts (exact whatever the order of the adds)."""
        if self.subsample and self.subsample < DOC_LEN:
            cols = self.rng.choice(DOC_LEN, self.subsample, replace=False)
            docs = docs[:, cols]
        t = torch.as_tensor(np.ascontiguousarray(docs),
                            device=self.device).long()
        counts = torch.zeros(len(docs), VOCAB, dtype=torch.long,
                             device=self.device)
        counts.scatter_add_(1, t, torch.ones_like(t))
        return counts.to(torch.float64) / t.shape[1]

    def fit(self, docs, labels, steps=300, lr=1.0):
        x = self._feats(docs)
        y = torch.as_tensor(np.asarray(labels, float), device=self.device)
        for _ in range(steps):
            p = torch.sigmoid(x @ self.w + self.b)
            self.w -= lr * (x.T @ (p - y) / len(y))
            self.b -= lr * torch.mean(p - y)

    def score(self, docs) -> np.ndarray:
        x = self._feats(docs)
        return torch.sigmoid(x @ self.w + self.b).cpu().numpy()


def main(device=None):
    t0 = time.time()
    docs, gt = make_corpus()
    n_pos = int(gt.sum())
    print(f"corpus: {N_DOCS} docs, {n_pos} about topic X")

    # --- landmarks: oracle labels on a sparse regular sample (1-in-30)
    lm_idx = np.arange(0, N_DOCS, 30)
    lm_labels = np.array([oracle(docs[i]) for i in lm_idx])
    print(f"landmarks: {len(lm_idx)} docs oracle-labeled at 'capture'")

    # --- operator family: cheap subsampled scorer -> full-histogram scorer
    cheap = HistScorer(subsample=32, docs_per_s=2000.0, device=device)
    expensive = HistScorer(subsample=None, docs_per_s=150.0, device=device)
    cheap.fit(docs[lm_idx], lm_labels)
    expensive.fit(docs[lm_idx], lm_labels)

    # --- multipass ranking with upgrade (the ZC2 engine pattern)
    q = AsyncUploadQueue()
    found = 0
    t_cam = t_net = 0.0
    verified = {i: bool(lab) for i, lab in zip(lm_idx, lm_labels)}
    recent, initial_ratio = [], None
    progress = []

    for pass_no, op in enumerate((cheap, expensive)):
        if pass_no == 1:
            # k-rule fired (checked below) -> retrain on verified uploads
            vi = np.array(sorted(verified))
            expensive.fit(docs[vi], np.array([verified[i] for i in vi]))
            # alpha-band sanity: the next operator is meaningfully slower
            assert expensive.fps < ALPHA * cheap.fps * (1 / ALPHA)
        unsent = [i for i in range(N_DOCS) if not q.uploaded(i)]
        scores = op.score(docs[unsent])
        dt_cam = 1.0 / op.fps
        upgrade_now = False
        for ci, i in enumerate(unsent):
            t_cam += dt_cam
            q.rank(t_cam, i, float(scores[ci]))
            # network lane drains concurrently
            while t_net < t_cam and found < n_pos:
                idx, t_next = q.pop_best(t_net)
                if idx is None:
                    if t_next is None or t_next > t_cam:
                        break
                    t_net = t_next
                    continue
                t_net += 1.0 / UPLINK_DOCS_PER_S
                q.mark_uploaded(idx)
                pos = oracle(docs[idx])
                verified[idx] = pos
                recent.append(pos)
                if pos:
                    found += 1
                    progress.append((t_net, found / n_pos))
                if len(recent) >= 30:
                    ratio = float(np.mean(recent[-30:]))
                    if initial_ratio is None:
                        initial_ratio = max(ratio, 1e-3)
                    if pass_no == 0 and quality_declined(ratio,
                                                         initial_ratio):
                        upgrade_now = True
                        break
            if upgrade_now or found >= n_pos:
                break
        if found >= n_pos:
            break
    # drain
    while found < n_pos:
        idx, t_next = q.pop_best(t_net)
        if idx is None:
            if t_next is None:
                break
            t_net = t_next
            continue
        t_net += 1.0 / UPLINK_DOCS_PER_S
        q.mark_uploaded(idx)
        if oracle(docs[idx]):
            found += 1
            progress.append((t_net, found / n_pos))

    def time_to(frac):
        for tt, v in progress:
            if v >= frac:
                return tt
        return None

    blind = N_DOCS / UPLINK_DOCS_PER_S * 0.99   # upload-all baseline ~t99
    print(f"retrieved {found}/{n_pos} topic docs")
    for frac in (0.5, 0.9, 0.99):
        tt = time_to(frac)
        if tt:
            print(f"  {frac:>4.0%} after {tt:7.1f} simulated s "
                  f"(blind upload-all: ~{blind * frac:.0f} s)")
    print(f"  uploads: {sum(1 for i in range(N_DOCS) if q.uploaded(i))} "
          f"of {N_DOCS} docs (k-rule constant K={K_DECLINE})")
    print(f"(host wall time {time.time() - t0:.0f}s)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the scorer runs: the card (cuda) unless "
                         "given, e.g. cpu")
    main(ap.parse_args().device)
