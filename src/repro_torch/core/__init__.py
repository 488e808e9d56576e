"""ZC² — the paper's contribution: a camera/cloud runtime for
retrospective queries over cold video on zero-streaming cameras.

Ported so far: video substrate (video.py), cost models (hardware.py),
detector oracle (oracle.py), capture-time landmarks (landmarks.py,
skew.py, flow.py), the on-camera operator family (operators.py,
factory.py), the batched scoring runtime (runtime.py), cloud-side online
training (training.py), upgrade policies (upgrade.py), the query model
and shared bootstrap (query.py, session.py, stepper.py, queue.py) and
the Retrieval executor (ranking.py)."""
