"""The control of the benchmark's comparison: the reference computed with
its meshes and edge table in bfloat16, put in the program's place, held to
the float32 reference on the same windows of the same frames that a run
compares. Every seed has to read differing pixels (a sound comparison
fails it); the program's runs read 0.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

runs at the cell's own size on the host alone (the reference is NumPy)
and prints one JSON line a seed.
"""

import argparse
import json
import os
import sys
import time


def main(argv):
    from portbench import catalog, harness, scene as scenes
    from portbench import traffic as traffics

    p = argparse.ArgumentParser(prog="portbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=2000,
                   help="frames a window holds, the sample's range")
    args = p.parse_args(argv)
    cell = catalog.workload(catalog.benchmark(), args.workload)
    cfg, mix = catalog.config(cell["config"]), catalog.traffic(
        cell["traffic"])
    h, w = mix["height"], mix["width"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        sg, tr_d, li_d = scenes.build(cfg, h, w, harness.rng(seed, "scene"))
        orbit = traffics.Orbit(mix, harness.rng(seed, "orbit"))
        sampler = harness.Reservoir(mix["check"]["frames"],
                                    harness.rng(seed, "sample"))
        for i in range(args.frames):
            sampler.offer(i, None)
        bad, compared, covered = harness.check_windows(
            sampler.frames(), sg, tr_d, li_d, orbit, h, w, mix, seed,
            lower=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_differing_px": bad,
                          "compared_px": compared, "covered_px": covered,
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
