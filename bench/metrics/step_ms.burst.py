"""Engine: mean wall of a serving step inside the window, in ms, in the
burst cells (program span: the benchmark's own clock around each
``ServingCore`` step, from its scheduling call to ``on_step``)."""
from bench.metrics._step import step_ms as read  # noqa: F401
