"""The benchmark of lcgan_torch, the PyTorch and CUDA port of LC-GAN.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result as the last line of standard output. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is a
file of its own that the harness finds by name:

* ``configs/<config>.json``: the configuration's flags, source and cut;
* ``traffic/<traffic>.json``: the mix's parameters and the driver that runs it;
* ``workloads/<cell>.json``: the limits of the cell's comparison;
* ``drivers/<driver>.py``: how a kind of traffic drives the port;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

``reference/`` holds the plain float32 reference the port is held against;
it imports nothing of the port.
"""
