"""What several readers share: the kernels the port launches for each
function of the inner step, by their names in the profiler's trace."""
RESAMPLE_KERNELS = ("resample_count_kernel", "resample_sorted_kernel")  # K1, K3
PROPAGATE_KERNELS = ("step_kernel", "ucsv_raw_kernel", "ucsv_norm_kernel",
                     "ucsv_norm_loop_kernel")  # K2 (Triton), K6


def traced_steps(ctx) -> int:
    return sum(rec["inner_steps"] for _, _, rec in ctx.traced_calls)
