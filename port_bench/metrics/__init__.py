"""One reader a metric, ``<metric>.py`` with ``read(ctx)``: the value, or
None where the run has nothing to read."""
