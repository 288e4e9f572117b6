"""The port's tools: the large-landmark stress run, the solver crossover,
the roofline table, the split of ``initialize()`` and the kitti07-scale
parity against the oracle, each a module with ``main(argv)`` run as
``python -m cuba_tpu_torch.tools.<name>``; ``roofline`` is the yardstick
they share with ``chip_smoke.py``.  The ``probe_*`` scripts run by path."""
