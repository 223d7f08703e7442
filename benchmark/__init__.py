"""The benchmark of the PyTorch port `wedetect_tpu_torch` on one H100.

Run a cell with `python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the checkout's root; see harness.py.
"""
