"""The CPU baseline, recorded beside the benchmark and never a metric:
the port's native C++ golden (``tpu_renderer_torch/golden/native.py``,
g++ -O3 -march=native) rendering each cell's scene at one of its orbit's
angles, at one thread and at all the host's threads.

    python3 portbench/cpu_baseline.py --workloads <cell> ... [--reps 5]

prints one JSON line a cell: median ms a frame of ``reps`` timed frames
after one warm-up, at each thread count, the better of the two, and the
host's CPU.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main(argv):
    from portbench import catalog, harness, scene as scenes
    from portbench import traffic as traffics
    from portbench.reference import frame as ref
    from tpu_renderer_torch.golden import native

    p = argparse.ArgumentParser(prog="portbench/cpu_baseline.py")
    p.add_argument("--workloads", nargs="+", required=True)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    info = native.cpu_info()
    for name in args.workloads:
        cell = catalog.workload(catalog.benchmark(), name)
        cfg = catalog.config(cell["config"])
        mix = catalog.traffic(cell["traffic"])
        h, w = mix["height"], mix["width"]
        sg, tr, li = scenes.build(cfg, h, w, harness.rng(args.seed, "scene"))
        orbit = traffics.Orbit(mix, harness.rng(args.seed, "orbit"))
        rot = orbit.matrices[orbit.index(0)]
        sg = [(ref.rotate(o, rot), c) for o, c in sg]
        out = {"workload": name, "threads_all": os.cpu_count(),
               "cpu": info.get("model name", "?")}
        for threads in (1, 0):
            native.render(sg, tr, li, h, w, num_threads=threads)
            ms = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                native.render(sg, tr, li, h, w, num_threads=threads)
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"ms_threads_{threads or 'all'}"] = statistics.median(ms)
        out["ms_better"] = min(out["ms_threads_1"], out["ms_threads_all"])
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
