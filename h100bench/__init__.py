"""The port's benchmark: ccsx_tpu_torch on one H100, one cell a run
(``python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``)."""
