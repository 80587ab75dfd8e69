"""The general parts of a run: discovery, inputs, the window, the trace,
the device and the import check."""
