"""The benchmark of ``distributedfft_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout on a machine that holds the cards the cell asks for::

    python3 -m h100bench.run --workload grid512_1card.c2c --seed 7 \\
        --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (grid, ranks, decomposition,
  an optional 2D ``grid`` of ranks, the planner keywords of its
  exchange under ``plan``, precision), its source, what was cut, its
  limits and its control;
- ``references/<reference>.py``: the plain reference a configuration
  names (plain PyTorch, nothing of the port);
- ``traffic/<mix>.json``: the parameters the one generator reads (the
  transform, its flops factor, planner keywords under ``plan`` that
  override the configuration's);
- ``metrics/<metric>.py``: one reader per metric.

The yardstick (flop and byte counts, the peaks, the percentile, the join
of profiler records to spans, the kernel classes, the comparison that
decides ``correct``) lives here too, so a change to the program cannot
move it. Nothing here imports ``jax`` or the JAX package.
"""
