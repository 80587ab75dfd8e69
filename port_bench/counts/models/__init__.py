"""One module a model, ``<model>.py``, found by the configuration's
``model`` name: ``NORMALS``, the standard normals its propagate draws a
particle, and ``UPDATE_OPS``, the operations of its update a particle,
each counted in its docstring. The update is counted op for op, a
multiply-add as one and an exp as a scale and an ex2 (``chip_smoke.py``'s
convention, which ``tools/sass_count.py`` holds against the kernels'
machine code)."""
