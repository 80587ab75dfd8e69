"""One module a prior kind, ``<kind>.py``, found by the kind's name in a
configuration's prior row ``[kind, *params]``. Each gives:

- ``ARITY``: the number of parameters;
- ``PROGRAM``: the name of the port's distribution that takes the same
  parameters, in the same order (``entries/_common.py::program_prior``),
  or None where the port has none;
- ``sample(generator, m, device, p)``: m float64 draws, from one call on
  the device;
- ``in_support(x, p)``: a bool tensor, where x lies in the support;
- ``log_prob(x, p)``: the log density at x (read only inside the support).

``p`` is the row's parameters as a list of floats."""
