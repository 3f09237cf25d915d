"""Shared arithmetic of the ``decode_attn_roofline`` readers: the least
time of the decode steps' attention in the profiled slice (the
architecture's ``decode_bound_s``, every layer of a step) over the device
time of the kernel's split and merge functions there, in %."""


def roofline(ctx, kernel: str, paged: bool):
    s = ctx.window.slice
    if s is None or bool(ctx.engine_paged) != paged:
        return None
    device_s, calls = s.kernel_s(kernel)
    if not calls or device_s <= 0:
        return None
    block = ctx.engine["block_size"] if paged else 0
    bound = sum(ctx.arch.decode_bound_s(ctx.model, positions, block)
                for _t, positions, profiled in ctx.window.decode_calls
                if profiled)
    return 100.0 * bound / device_s
