"""One reader a metric, ``<metric>.py`` with ``read(run)``, found by the
metric's name in ``BENCHMARK.json``; ``_work.py`` holds the operation and
byte counts they share."""
