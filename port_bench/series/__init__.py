"""One generator a series kind, ``<kind>.py`` with ``make(spec, t)``: the
configuration's ``series`` object and the length, in, a float32 NumPy
array of length ``t`` out, drawn from the object's fixed ``seed``
(:func:`port_bench.harness.series.make` finds it by ``spec["kind"]``)."""
