"""The port's benchmark: one cell of ``BENCHMARK.json`` a run
(``python3 -m portbench.run``), driven by data: a configuration, a mix
and a metric are files found by their names (``portbench.spec``)."""
