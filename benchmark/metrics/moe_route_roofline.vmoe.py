"""The V-MoE's memory-bound MoE kernels (ops/moe.py, csrc/moe.cu): the
dispatch (u's rows gathered into expert order), the bias-GELU over the
first grouped product and the combine back into token order. Their least
time over their kernels' device time in the traced slice, in %. A launch's
least time is the larger of its bytes (inputs read once, outputs written
once: work_vmoe.route_stages, at the engine's rows a launch) over the
memory rate and its elementwise FLOPs over the f32 peak. The route kernel
(latency-bound: 3.9 MB a launch) is not counted. None unless the span
slice's engine.call spans say that the engine ran the V-MoE (network
'vmoe_b16')."""

from benchmark import spans, work, work_vmoe

# the kernels of each stage, as the trace names them
KERNELS = {"dispatch": ("moe_dispatch_kernel",),
           "bias_gelu": ("moe_bias_gelu_kernel",),
           "combine": ("moe_combine_kernel",)}


def read(ctx):
    rec = spans.record(ctx)
    if ctx.trace is None or rec is None or not any(
            s.attrs.get("network") == "vmoe_b16"
            for s in rec.find("engine.call", device=False)):
        return None
    stages = work_vmoe.route_stages(ctx.config["model"],
                                    ctx.driver.rows_per_launch,
                                    ctx.config["precision"])
    least = total = 0.0
    for stage, names in KERNELS.items():
        n, t = ctx.trace.kernel_time(names)
        if not n:
            return None
        least += n * work.least_s(*stages[stage], ctx.device_name, "float32")
        total += t
    return 100.0 * least / total
