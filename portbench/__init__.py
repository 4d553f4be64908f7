"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

Run one cell with ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Importing this
package loads nothing.
"""
