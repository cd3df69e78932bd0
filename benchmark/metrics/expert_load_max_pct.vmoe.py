"""The load on the busiest expert: in each sparse layer, the rows its
busiest expert took over the mean expert's, in %, the largest over the
sparse layers (100 is an even load; E x 100 / k is every token on one
expert). Read from the program's counters moe.expert_rows/<layer>/<expert>
(the engine's expert_rows(), which the driver reads at the end of the span
slice: that slice's rows, the sentinel padding's included). None unless
the span slice's engine.call spans say that the engine ran the V-MoE
(network 'vmoe_b16') and the counters are there."""

from collections import defaultdict

from benchmark import spans

PREFIX = "moe.expert_rows/"


def read(ctx):
    rec = spans.record(ctx)
    if rec is None or not any(s.attrs.get("network") == "vmoe_b16"
                              for s in rec.find("engine.call", device=False)):
        return None
    layers = defaultdict(list)
    for name, n in getattr(rec, "counts", {}).items():
        if name.startswith(PREFIX):
            layer, _ = name[len(PREFIX):].split("/")
            layers[layer].append(n)
    shares = [100.0 * max(rows) * len(rows) / sum(rows)
              for rows in layers.values() if sum(rows)]
    return max(shares) if shares else None
