"""Bytes and operations that each function of the inner step needs, from
its shapes alone (never from a kernel), and the card's published peaks.
Each input byte is read once and each output byte written once (float32,
4 bytes)."""
