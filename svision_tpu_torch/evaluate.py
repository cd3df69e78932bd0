"""Accuracy evaluation: calls vs planted truth.

Scores a VCF produced by the pipeline against a list of simulated events
(kind, chrom, anchor, size) — the closed-loop counterpart of the reference's
external truvari/PAV evaluations (SURVEY.md §6). Matching is by breakpoint
proximity and type compatibility; DUP/tDUP are accepted for each other since
the reference's refine_type freely reclassifies between them
(output.py:352-467)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

_COMPATIBLE = {
    "DEL": {"DEL"},
    "INS": {"INS"},
    "INV": {"INV"},
    "DUP": {"DUP", "tDUP"},
    "tDUP": {"tDUP", "DUP"},
}


def parse_vcf_calls(vcf_path: str) -> List[Dict]:
    """[{chrom, pos, end, types:set, qual, filter, gt}] from a pipeline
    VCF. gt is the sample GT field ("./." when absent)."""
    calls = []
    for line in open(vcf_path):
        if line.startswith("#") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
        types = set()
        svtype = info.get("SVTYPE", "")
        for t in svtype.split("+"):
            if t:
                types.add(t)
        for part in info.get("BKPS", "").split(","):
            if ":" in part:
                types.add(part.split(":", 1)[0])
        gt = "./."
        if len(f) > 9 and "GT" in f[8].split(":"):
            gt = f[9].split(":")[f[8].split(":").index("GT")]
        # per-type breakpoint lengths from BKPS ("type:len-start-end"):
        # the length axis of the breakpoint-resolution evaluation
        lens: Dict[str, int] = {}
        for part in info.get("BKPS", "").split(","):
            if ":" in part:
                t, rest = part.split(":", 1)
                try:
                    lens.setdefault(t, int(rest.split("-", 1)[0]))
                except ValueError:
                    pass
        calls.append(dict(chrom=f[0], pos=int(f[1]),
                          end=int(info.get("END", f[1])), types=types,
                          lens=lens, qual=f[5], filter=f[6], gt=gt))
    return calls


def score_calls(calls: Sequence[Dict],
                truth: Sequence[Tuple[str, str, int, int]],
                tol: int = 1000,
                truth_gt: Sequence[str] = None,
                strict_tols: Sequence[int] = (10, 50, 500)):
    """Greedy 1:1 matching of calls to truth events.

    Returns {per_type: {kind: {tp, fn, support...}}, precision, recall, f1,
    tp, fp, fn}. A call matches an event when it is within `tol` of the
    anchor and carries a compatible type.

    truth_gt: optional per-event genotype truth ("0/1"/"1/1") — adds
    gt_concordance (fraction of MATCHED events whose call GT equals the
    truth, unordered alleles) plus gt_eval/gt_correct counts. Only simple
    (single-component) events are scored: the reference genotyper leaves
    CSVs at ./. by design (genotype.py:55-62).

    Breakpoint-resolution axis (the reference's flagship CSV claim is
    EXACT-breakpoint-match recall across stringencies,
    supports/performance/csv_exact_match.png): the result carries `bkp` —
    the |dpos| distribution over matched components (mean/median/p95/max
    and the fraction within each strict tolerance) and the |dlen|
    distribution where the matched record's BKPS length is comparable —
    plus `strict_recall`, the recall of an independent re-match at each
    tolerance in `strict_tols` (greedy matching is re-run, not filtered,
    so a strict match may pair different records)."""
    calls = list(calls)
    used = [False] * len(calls)
    per_type: Dict[str, Dict[str, int]] = {}
    tp = 0
    gt_eval = gt_correct = 0
    # per-chrom sorted (pos, idx)/(end, idx) tables: candidates within tol
    # of an anchor come from two bisections instead of a full scan — the
    # O(truth x calls) loop was ~10^9 steps at whole-genome scale
    # (25k events x 28k records); greedy semantics are unchanged because
    # candidates are visited in ascending call index, matching the original
    # first-lowest-index tie behavior of the strict `d < best` test
    import bisect
    by_chrom: Dict[str, Dict[str, list]] = {}
    for i, c in enumerate(calls):
        t = by_chrom.setdefault(c["chrom"], {"pos": [], "end": []})
        t["pos"].append((c["pos"], i))
        t["end"].append((c["end"], i))
    for t in by_chrom.values():
        t["pos"].sort()
        t["end"].sort()

    def _near(chrom: str, anchor: int) -> list:
        t = by_chrom.get(chrom)
        if t is None:
            return []
        out = set()
        for key in ("pos", "end"):
            arr = t[key]
            lo = bisect.bisect_left(arr, (anchor - tol, -1))
            hi = bisect.bisect_right(arr, (anchor + tol, len(calls)))
            out.update(i for _, i in arr[lo:hi])
        return sorted(out)

    dpos: List[int] = []
    dlen: List[int] = []
    for ti, (kind, chrom, anchor, size, *_aux) in enumerate(truth):
        stats = per_type.setdefault(kind, {"tp": 0, "fn": 0})
        # compound events ("DEL+INS", "INV+DEL"): every component must be
        # carried by a nearby call — either one <CSV> record with multiple
        # BKPS types or adjacent simple records (both are faithful shapes,
        # depending on whether the component signatures co-cluster)
        components = kind.split("+")
        comp_sizes = [size] + list(_aux[:len(components) - 1])
        event_calls: set = set()
        comp_best: List[Tuple[int, int, str, int]] = []
        ok = True
        near = _near(chrom, anchor)     # same anchor for every component
        for ck, comp in enumerate(components):
            best = None
            for i in near:
                c = calls[i]
                if used[i]:
                    continue
                if not (c["types"] & _COMPATIBLE.get(comp, {comp})):
                    continue
                # either breakpoint may sit at the planted anchor: DUP calls
                # report the duplicated SOURCE span, whose END is the
                # insertion point (refine_type semantics)
                d = min(abs(c["pos"] - anchor), abs(c["end"] - anchor))
                if d <= tol and (best is None or d < best[0]):
                    best = (d, i)
            if best is None:
                ok = False
                break
            event_calls.add(best[1])
            want_size = (comp_sizes[ck] if ck < len(comp_sizes)
                         and isinstance(comp_sizes[ck], int) else None)
            comp_best.append((best[0], best[1], comp, want_size))
        if ok:
            for d, i, comp, want_size in comp_best:
                dpos.append(d)
                if want_size is not None:
                    got = None
                    for t in _COMPATIBLE.get(comp, {comp}):
                        if t in calls[i].get("lens", {}):
                            got = calls[i]["lens"][t]
                            break
                    if got is not None:
                        dlen.append(abs(got - want_size))
            for i in event_calls:
                used[i] = True
            stats["tp"] += 1
            tp += 1
            if truth_gt is not None and len(components) == 1:
                want = truth_gt[ti]
                got = calls[next(iter(event_calls))].get("gt", "./.")
                gt_eval += 1
                norm = lambda g: frozenset(g.replace("|", "/").split("/"))
                gt_correct += norm(got) == norm(want)
        else:
            stats["fn"] += 1
    fp = sum(1 for u in used if not u)
    fn = len(truth) - tp
    # units must not mix: recall is event-level (matched truth events /
    # truth events); precision is call-level (truth-supporting calls /
    # calls) — a compound event matched by two adjacent simple records
    # contributes two supporting calls, not one event against two units
    tp_calls = sum(1 for u in used if u)
    precision = tp_calls / len(calls) if calls else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    def _dist(vals: List[int]) -> Dict:
        if not vals:
            return {"n": 0}
        v = sorted(vals)
        n = len(v)
        return {"n": n, "mean": round(sum(v) / n, 2),
                "median": v[n // 2], "p95": v[min(n - 1, int(n * 0.95))],
                "max": v[-1]}

    bkp = {"dpos": _dist(dpos), "dlen": _dist(dlen)}
    if dpos:
        bkp["dpos_within"] = {
            str(t): round(sum(1 for d in dpos if d <= t) / len(dpos), 4)
            for t in sorted(set(list(strict_tols) + [tol]))}
    out = dict(per_type=per_type, tp=tp, fp=fp, fn=fn, tp_calls=tp_calls,
               n_calls=len(calls), precision=round(precision, 4),
               recall=round(recall, 4), f1=round(f1, 4), bkp=bkp)
    if strict_tols:
        # independent greedy re-match per stringency (the paper's
        # exact-match axis): recall/precision at each tolerance
        out["strict_recall"] = {}
        for t in sorted(strict_tols):
            if t >= tol:
                continue
            sub = score_calls(calls, truth, tol=t, truth_gt=None,
                              strict_tols=())
            out["strict_recall"][str(t)] = {
                "recall": sub["recall"], "precision": sub["precision"]}
    if truth_gt is not None:
        out["gt_eval"] = gt_eval
        out["gt_correct"] = gt_correct
        out["gt_concordance"] = (round(gt_correct / gt_eval, 4)
                                 if gt_eval else 0.0)
    return out


def score_vcf(vcf_path: str, truth, tol: int = 1000, truth_gt=None):
    return score_calls(parse_vcf_calls(vcf_path), truth, tol=tol,
                       truth_gt=truth_gt)
