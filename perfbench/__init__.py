"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
cell a run, ``python3 perfbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``)."""
