"""A cell small enough for the host: 300-400 base inserts, 3-6 passes."""

import types

from h100bench.gen import corpus
from h100bench.harness import spec

MIX = {"template": {"law": "uniform", "lo": 300, "hi": 400},
       "full_passes": {"law": "uniform", "lo": 3, "hi": 6},
       "partial_ends": True, "read_through_every": 5,
       "interrupt": {"prob": 0.0},
       "pool_holes": 6, "warm_holes": 2, "sample_holes": 3}
CONFIG = {"flags": ["-m", "500"], "movie": "mv",
          "errors": {"sub_rate": 0.02, "ins_rate": 0.05, "del_rate": 0.05}}
SEED = 2_200_000_017


def run(tmp_path, seconds, trace=0, seed=SEED):
    """One run of the tiny cell on the host: the harness's window and check
    around the port's batched driver on the CPU."""
    from h100bench.harness import cell as cell_mod

    bench = spec.load_bench()
    c = spec.Cell(name="tiny", chips=1, config=CONFIG, mix=MIX,
                  config_name="tiny", traffic_name="tiny",
                  end_to_end=bench["end_to_end"],
                  per_layer=bench["per_layer"])
    bam, man, gen_s, _ = corpus.build(str(tmp_path / "corpus"), seed,
                                      MIX["pool_holes"], MIX,
                                      CONFIG["errors"], "mv", workers=1)
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return cell_mod.run_cell(c, args, bam, man, 0.0, gen_s, device="cpu",
                             extra_flags=["--batch", "on"],
                             work_dir=str(tmp_path))
