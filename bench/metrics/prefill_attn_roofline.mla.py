"""Kernels: the prefill kernel's MLA instance (query and key rows of 192,
value rows of 128) and its share of its roofline in the profiled slice, in
% (device trace): the architecture's ``prefill_bound_s`` of the prefill
dispatches the slice served (each dispatch's chunks, the padding lanes of
an MoE first chunk left out) over that instance's device time there."""

KERNEL = "flash_prefill_mla_kernel"


def read(ctx):
    w = ctx.window
    s = w.slice
    bound_of = getattr(ctx.arch, "prefill_bound_s", None)
    if s is None or bound_of is None or len(w.paused) < 2:
        return None
    device_s, calls = s.kernel_s(KERNEL)
    if not calls or device_s <= 0:
        return None
    # the profiler ran from the first pause's end to the second's start, on
    # the serving clock; a dispatch's time is that of its first chunk
    t0, t1 = w.paused[0][1], w.paused[1][0]
    bound, i = 0.0, 0
    for call in w.prefill_calls:
        t = w.prefill_tokens[i][0]
        i += len(call)
        if t0 <= t < t1:
            bound += bound_of(ctx.model, [(a, b) for _r, a, b in call])
    return 100.0 * bound / device_s if bound else None
