"""The benchmark of the PyTorch/CUDA port (`artgraph_tpu_torch`).

`benchmarks/run.py` runs one cell of `BENCHMARK.json` once. This package is
its yardstick: the entries the cells' windows drive (`entries/`), the
model layer, a module per trunk (`trunks/`), the seeded inputs and weights
(`inputs.py`), the plain reference and its lower-precision control
(`reference.py`), the comparison that decides `correct` (`check.py`), the
FLOP and byte counts (`flops.py`), the device peaks (`peaks.json`) and the
profiler-trace arithmetic (`trace.py`). It imports nothing of the JAX
package, and `reference.py` and the plain trunks nothing of the port.
"""
