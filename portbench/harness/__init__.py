"""The benchmark's harness: discovery by name, the measured window, the
workload runners, the profile reduction and the yardsticks.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell lives in a file of its own under ``portbench/`` (``configs/``,
``traffic/``, ``metrics/``, ``limits/``), found by the name that
``BENCHMARK.json`` gives it.
"""
