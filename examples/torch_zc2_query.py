"""Full query runner of the PyTorch/CUDA port: any scene, any query
type, optional baselines; operators scored on the card through the
port's CUDA kernels.

    PYTHONPATH=src python examples/torch_zc2_query.py --video Chaweng \
        --kind retrieval --hours 1.0 --baselines

    PYTHONPATH=src python examples/torch_zc2_query.py --video JacksonH \
        --kind tagging --error-budget 0.01

    PYTHONPATH=src python examples/torch_zc2_query.py --video Banff \
        --kind count_max

    # many concurrent queries over many cameras (FleetService):
    PYTHONPATH=src python examples/torch_zc2_query.py --fleet 8 --hours 0.25

    # the plain PyTorch path on the host, without a card:
    PYTHONPATH=src python examples/torch_zc2_query.py --device cpu --hours 0.1

This is the end-to-end runner for the paper's system: camera capture ->
landmarks -> cloud query planning -> multipass execution with online
operator upgrade -> online results, against the same discrete-event
camera/network cost models as the benchmarks. ``--fleet N`` instead
submits N mixed queries over 3 cameras to one FleetService: cross-query
batched scoring, shared-uplink contention, streaming per-query
progress. The counterpart of ``examples/zc2_query.py`` (the JAX
package): the same flags, and ``--device`` (the card unless asked
otherwise)."""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.core import landmarks as lm
from repro_torch.core.baselines import (cloud_only_retrieval, cloud_only_tagging,
                                  optop_retrieval, preindex_retrieval,
                                  preindex_tagging)
from repro_torch.core.counting import MaxCountExecutor, SampleCountExecutor
from repro_torch.core.filtering import TaggingExecutor, tag_accuracy
from repro_torch.core.hardware import DETECTORS, NetworkModel
from repro_torch.core.query import Query, make_env
from repro_torch.core.ranking import RetrievalExecutor
from repro_torch.core.runtime import OperatorRuntime, set_runtime
from repro_torch.core.video import QUERY_CLASS, Video, corpus


def describe(name, env, prog):
    video_s = env.n_frames / env.video.spec.fps
    done = prog.done_t or 0
    print(f"\n-- {name} --")
    for frac in (0.5, 0.9, 0.99):
        t = prog.time_to(frac)
        if t:
            print(f"   {frac:>4.0%}: {t:9.1f} s  ({video_s / t:,.0f}x realtime)")
    print(f"   done: {done:8.1f} s   uploads: {prog.bytes_up / 1e6:.1f} MB   "
          f"op switches: {len(prog.op_switches)}")


def run_fleet(n_queries: int, hours: float, uplink_mbps: float,
              detector: str, full_family: bool) -> None:
    """N mixed queries over 3 cameras through one FleetService."""
    from repro_torch.core.runtime import get_runtime
    from repro_torch.serving.fleet import FleetService

    cams = ["JacksonH", "Banff", "Miami"]
    kinds = ["retrieval", "tagging", "count_max", "count_avg"]
    net = NetworkModel(uplink_bytes_per_s=uplink_mbps * 125_000)
    svc = FleetService(contended=True, full_family=full_family,
                       train_steps=50)
    print(f"fleet: {n_queries} queries over {len(cams)} cameras "
          f"(shared uplink, cross-query batching)")
    for name in cams:
        video = Video(corpus(hours=hours)[name])
        svc.register_camera(name, video,
                            lm.build_landmarks(video, 30,
                                               DETECTORS[detector]))
    step_kw = {"retrieval": {"max_passes": 3}, "tagging": {},
               "count_max": {"max_passes": 3}, "count_avg": {}}
    for i in range(n_queries):
        cam, kind = cams[i % len(cams)], kinds[i % len(kinds)]
        svc.submit(cam, Query(kind, QUERY_CLASS[cam]), net=net,
                   **step_kw[kind])

    def stream(qid, t, v):
        print(f"   [{t:9.1f}s] {qid:<28} -> {v:6.1%}")

    rt = get_runtime()
    calls0 = rt.calls
    results = svc.run(on_progress=stream)
    print(f"\n-- fleet summary ({len(results)} queries, "
          f"{rt.calls - calls0} operator dispatches, "
          f"{svc.scheduler.stats['score_rounds']} batched score rounds) --")
    for qid, prog in results.items():
        print(f"   {qid:<28} done {prog.done_t:9.1f} s   "
              f"{prog.bytes_up / 1e6:6.1f} MB   "
              f"{len(prog.op_switches)} op switches")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", default="Banff", choices=sorted(QUERY_CLASS))
    ap.add_argument("--kind", default="retrieval",
                    choices=["retrieval", "tagging", "count_max",
                             "count_mean", "count_median"])
    ap.add_argument("--hours", type=float, default=1.0)
    ap.add_argument("--interval", type=int, default=30)
    ap.add_argument("--detector", default="yolov3",
                    choices=sorted(DETECTORS))
    ap.add_argument("--uplink-mbps", type=float, default=8.0,
                    help="uplink bandwidth (megabit/s)")
    ap.add_argument("--error-budget", type=float, default=0.01)
    ap.add_argument("--full-family", action="store_true",
                    help="the paper's ~40-operator family (slower host)")
    ap.add_argument("--baselines", action="store_true")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="run N concurrent mixed queries over 3 cameras "
                         "through the FleetService instead of one query")
    ap.add_argument("--device", default=None,
                    help="where operators score and train: the card "
                         "(cuda) unless given, e.g. cpu")
    args = ap.parse_args()
    set_runtime(OperatorRuntime(device=args.device))

    if args.fleet:
        run_fleet(args.fleet, args.hours, args.uplink_mbps, args.detector,
                  args.full_family)
        return

    cls = QUERY_CLASS[args.video]
    print(f"scene={args.video} class={cls} kind={args.kind} "
          f"hours={args.hours}")
    video = Video(corpus(hours=args.hours)[args.video])
    store = lm.build_landmarks(video, args.interval,
                               DETECTORS[args.detector])
    net = NetworkModel(uplink_bytes_per_s=args.uplink_mbps * 125_000)

    def env():
        return make_env(video, Query(args.kind, cls,
                                     error_budget=args.error_budget),
                        store, net=net)

    if args.kind == "retrieval":
        e = env()
        describe("ZC2", e, RetrievalExecutor(
            e, full_family=args.full_family).run())
        if args.baselines:
            e = env(); describe("CloudOnly", e, cloud_only_retrieval(e))
            e = env(); describe("OptOp", e, optop_retrieval(
                e, full_family=args.full_family))
            e = env(); describe("PreIndexAll", e, preindex_retrieval(e))
    elif args.kind == "tagging":
        e = env()
        ex = TaggingExecutor(e, full_family=args.full_family)
        describe("ZC2", e, ex.run())
        acc = tag_accuracy(e, ex.tags)
        print(f"   tag accuracy: fn_rate={acc['fn_rate']:.4f} "
              f"fp_rate={acc['fp_rate']:.4f} "
              f"agreement={acc['agreement']:.3f}")
        if args.baselines:
            e = env(); describe("CloudOnly", e, cloud_only_tagging(e))
            e = env(); describe("PreIndexAll", e, preindex_tagging(e))
    elif args.kind == "count_max":
        e = env()
        describe("ZC2", e, MaxCountExecutor(
            e, full_family=args.full_family).run())
    else:
        stat = args.kind.split("_")[1]
        e = env()
        describe("ZC2", e, SampleCountExecutor(e, stat=stat).run())


if __name__ == "__main__":
    main()
