"""The V-MoE's grouped expert products (ops/moe.expert_mm: torch's
_grouped_mm, two a sparse layer a batch): their least time over their
kernels' device time in the traced slice, in %. A launch's least time is
the larger of its bytes (the routed rows in, every expert's matrix, the
products out: work_vmoe.gemm_stages, at the engine's rows a launch) over
the memory rate and its FLOPs (2 x routed rows x 768 x 3,072) over the
precision's peak; the two products of a layer alternate, so each launch
takes their mean. None unless the span slice's engine.call spans say that
the engine ran the V-MoE (network 'vmoe_b16')."""

from benchmark import spans, spec, work, work_vmoe

# a part of the name of the grouped products' kernel, as the trace names
# it: CUTLASS's grouped GEMM that torch._grouped_mm runs on sm90 (torch
# 2.11), whose name stays mangled there
# (_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9x
# INS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShape...), so it is
# matched as a part, not as a whole identifier; the small kernel that
# fills its problem sizes on the card (prepare_grouped_gemm_data) is not
# counted
PARTS = ("GroupProblemShape",)


def read(ctx):
    rec = spans.record(ctx)
    if ctx.trace is None or rec is None or not any(
            s.attrs.get("network") == "vmoe_b16"
            for s in rec.find("engine.call", device=False)):
        return None
    n, t = spec.metric("attn_roofline.vit").kernel_time(ctx.trace, PARTS)
    if not n:
        return None
    dtype = ctx.config["precision"]
    stages = work_vmoe.gemm_stages(ctx.config["model"],
                                   ctx.driver.rows_per_launch, dtype)
    mean = sum(work.least_s(b, f, ctx.device_name, dtype)
               for b, f in stages.values()) / len(stages)
    return 100.0 * n * mean / t
