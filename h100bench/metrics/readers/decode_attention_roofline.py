"""The decode attention's share of its roofline: the least time the decode
steps served while the profiler collected need for their attention on the
card (their FLOPs at the bf16 peak or their bytes at HBM's rate, whichever
is longer; ``metrics/work.py``), over the device time the trace gives the
kernels named under ``kernels/decode_attention_roofline/``, in %.  Nothing
without a trace."""
from h100bench.devtrace import kernel_patterns
from h100bench.metrics.work import decode_attention_work


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.device_seconds(kernel_patterns(ctx.root, "decode_attention_roofline"))
    if not t:
        return None
    flops, nbytes = decode_attention_work(ctx.model, ctx.traced_decodes)
    bound = max(flops / ctx.peaks["bf16_flops"], nbytes / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / t
