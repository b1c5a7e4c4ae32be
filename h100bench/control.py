"""The control of a cell's comparison, on the card at the cell's size.

For each seed: the holes a run of ``--admitted`` holes would check
(harness/check.chosen, from the same seed and corpus), and their records
made by the control: the plain reference with one refinement round fewer
(``refine_iters - 1``), the shortcut a faster program would be tempted by.
The control is put in the program's place: its records go through the
comparison that decides a run's ``correct`` (harness/check.check, which
works the sound reference out again, and check.verdict), and it has to come
out not correct on every seed.

    python3 h100bench/control.py --workload <cell> --admitted <n> \\
        --seeds <s> [<s> ...]

Prints one JSON line a seed.  The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time


def control_run(cell, seed: int, n_admitted: int, manifest,
                device: str = "cuda") -> dict:
    """The control's records of the holes a run of ``n_admitted`` holes of
    ``cell`` under ``seed`` would check, judged as a run's are."""
    from h100bench.gen import holes
    from h100bench.harness import check
    from h100bench.reference import driver

    mix, config = cell.mix, cell.config
    admitted = [(str(i), i) for i in range(n_admitted)]
    everyone = {h: "" for h, _ in admitted}
    pos = check.chosen(seed, admitted, everyone, manifest,
                       int(mix["sample_holes"]))
    sub = [admitted[p] for p in pos]
    sound = check.params(config, device)
    control = check.params(config, device,
                           refine_iters=sound.refine_iters - 1)
    inputs = {i: holes.make_hole(seed, i, mix, config["errors"]).passes
              for _, i in sub}
    t0 = time.perf_counter()
    made = driver.consensus(inputs, control)
    control_s = time.perf_counter() - t0
    records = [(f"{config['movie']}/{h}/ccs", check.decode(made[i]))
               for h, i in sub if made[i] is not None]
    # every hole of ``sub`` is checked: the sample is all of them
    res = check.check(records, sub, manifest, seed,
                      dict(mix, sample_holes=len(sub)), config,
                      device=device)
    return {"workload": cell.name, "seed": seed, "checked": res["checked"],
            "checks": {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in res["numbers"].items()},
            "correct": check.verdict(res["numbers"]),
            "control_s": control_s, "reference_s": res["reference_s"]}


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    from h100bench.gen import corpus
    from h100bench.harness import spec
    from h100bench.harness.cell import WORK_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--admitted", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    cell = spec.cell(a.workload)
    for seed in a.seeds:
        _, manifest, _, _ = corpus.build(
            os.path.join(WORK_DIR, "corpus", cell.name), seed,
            max(a.admitted, int(cell.mix["pool_holes"])), cell.mix,
            cell.config["errors"], cell.config["movie"])
        print(json.dumps(control_run(cell, seed, a.admitted, manifest,
                                     a.device)), flush=True)
