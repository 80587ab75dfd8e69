"""The port's examples: ``python -m sequential_monte_carlo_tpu_torch.examples.inflation``
and ``python -m sequential_monte_carlo_tpu_torch.examples.linear_gaussian``."""
