"""Model step: useful FLOPs of the tokens processed inside the window
(``bench/harness/flops.py``: routed experts only, no padded capacity)
over the window and the bf16 peak, in %, in the batch cells (program
counter)."""
from bench.metrics._step import step_mfu as read  # noqa: F401
