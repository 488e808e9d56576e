"""Quickstart of the PyTorch/CUDA port: one retrospective Retrieval query
on a zero-streaming camera, end to end, its operators scored on the card
through the port's CUDA kernels.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The counterpart of ``examples/quickstart.py`` (the JAX package), the
same four steps (the paper's Fig. 3 workflow):
  1. A synthetic 1-hour scene ("Banff", buses at a crossing) is captured
     to camera-local storage: nothing is streamed.
  2. At capture time the camera runs its best detector on 1-in-30 frames
     (sparse-but-sure landmarks).
  3. A query arrives: "retrieve all frames containing a bus". The cloud
     pulls landmark thumbnails, learns the spatial/temporal skew, breeds
     and trains cheap operators, and pushes them to the camera.
  4. The camera ranks frames in multiple passes (operators upgraded
     mid-query); positives stream back ordered best-first.
``--device``: where operators score and train, the card unless given
(``cpu`` runs the kernels' plain PyTorch versions on the host).
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

from repro_torch.core import landmarks as lm  # noqa: E402
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.ranking import RetrievalExecutor  # noqa: E402
from repro_torch.core.runtime import OperatorRuntime, set_runtime  # noqa: E402
from repro_torch.core.video import Video, corpus  # noqa: E402
from repro_torch.kernels import conv_scorer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the card (cuda) unless given, e.g. cpu")
    ap.add_argument("--hours", type=float, default=1.0)
    args = ap.parse_args()
    rt = OperatorRuntime(device=args.device)
    set_runtime(rt)
    t0 = time.time()
    print("== 1. capture (zero streaming) ==")
    video = Video(corpus(hours=args.hours)["Banff"])
    print(f"   scene=Banff frames={video.spec.num_frames} "
          f"(stored on camera; 0 bytes uploaded)")

    print("== 2. capture-time landmarks (1-in-30, best detector) ==")
    store = lm.build_landmarks(video, 30, YOLO_V3)
    print(f"   {len(store.landmarks)} landmarks with {YOLO_V3.name} labels")

    print("== 3. query: retrieve frames containing 'bus' ==")
    env = make_env(video, Query("retrieval", "bus"), store)
    print(f"   queried range: {env.n_frames} frames, "
          f"{env.n_positives} true positives")

    launches = conv_scorer.conv_scorer.launches
    prog = RetrievalExecutor(env, full_family=False).run()

    print("== 4. results (online: partial results stream in) ==")
    for frac in (0.25, 0.5, 0.9, 0.99):
        t = prog.time_to(frac)
        if t:
            print(f"   {frac:>4.0%} of positives after {t:8.1f} simulated s")
    video_s = env.n_frames / video.spec.fps
    print(f"   full query: {prog.done_t:.0f} s simulated "
          f"= {video_s / prog.done_t:.0f}x video realtime")
    print(f"   network: {prog.bytes_up / 1e6:.1f} MB uploaded "
          f"(all-streaming would be "
          f"{env.n_frames * env.net.frame_bytes / 1e6:.0f} MB)")
    print(f"   operators used: {[n for _, n in prog.op_switches]}")
    print(f"   scored on {rt.device}: {rt.calls} dispatches, "
          f"{conv_scorer.conv_scorer.launches - launches} conv kernel "
          f"launches")
    print(f"(host wall time {time.time() - t0:.0f}s)")


if __name__ == "__main__":
    main()
