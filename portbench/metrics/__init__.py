"""Metric readers, end-to-end and per-layer, one file each, found by the
metric's name in ``BENCHMARK.json``.

Each defines ``read(rec)``: the number from the run's record (see
``portbench/cell.py::window_record``), or None where there is nothing to
read, and then the harness leaves the metric out of the line."""
