"""First-party truvari-style SV benchmarking (VCF vs VCF).

The reference's published accuracy numbers come from external truvari runs
against GIAB HG002 Tier-1 and PAV assembly callsets (SURVEY.md §6;
`supports/performance/*.png`), but the reference repo ships no evaluation
code at all. This module is the checked-in equivalent: it scores a comparison
VCF against a truth ("base") VCF under truvari-bench's default matching
semantics, so external-callset calibration is runnable the moment a truth
VCF is available (GIAB Tier-1, a PAV callset, or another caller's output).

Implemented matching rules (truvari bench defaults):
  * entries enter comparison if sizemin <= |SVLEN| <= sizemax (truth side;
    comparison side uses the looser sizefilt lower bound) and, with
    --passonly, FILTER is PASS/'.'
  * a (base, comp) pair is a candidate when their breakpoints are within
    `refdist` (start-to-start or end-to-end) or their spans overlap
  * PctSizeSimilarity  = min(|len|)/max(|len|)        >= pctsize
  * PctRecOverlap      = reciprocal span overlap      >= pctovl (non-INS)
  * sequence similarity (python-Levenshtein ratio, the library truvari's
    seqsim uses, with the "unroll" position-shift harmonization)
    >= pctseq when pctseq > 0; a pair where either side lacks sequence
    FAILS the gate (truvari treats unresolved entries as seqsim 0) and is
    counted in the summary's `seq_unresolved_pairs`
  * SVTYPE must match unless typeignore (DUP and tDUP are treated as one
    type family, mirroring evaluate._COMPATIBLE / refine_type semantics)
  * greedy one-to-one assignment by descending match score
    (mean of the enabled similarity terms, distance as tiebreaker)

Counters follow truvari's definitions: recall = TP_base/(TP_base+FN) over
truth entries, precision = TP_comp/(TP_comp+FP) over comparison entries.

This is a clean-room implementation of the published matching semantics —
no truvari code was consulted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

try:                        # the same C library truvari's seqsim uses
    import Levenshtein as _lev
except ImportError:         # pure-python twin below (bit-parallel LCS)
    _lev = None

_TYPE_FAMILY = {"TDUP": "DUP", "DUP:TANDEM": "DUP", "DUP:INT": "DUP"}


def _canon_type(t: str) -> str:
    t = t.upper().lstrip("<").rstrip(">")
    return _TYPE_FAMILY.get(t, t)


@dataclass
class SvEntry:
    chrom: str
    start: int           # 1-based POS
    end: int
    svtype: str
    svlen: int           # absolute length
    filter: str
    seq: Optional[str] = None    # ALT sequence for sequence-resolved INS
    gt: Optional[str] = None
    line_no: int = 0
    types: Tuple[str, ...] = field(default_factory=tuple)  # CSV components


def parse_sv_entries(vcf_path: str) -> List[SvEntry]:
    """Minimal SV-aware VCF reader (plain or bgzipped path already opened
    upstream; here: plain text)."""
    out: List[SvEntry] = []
    sample_idx = 9
    for ln, line in enumerate(open(vcf_path)):
        if line.startswith("#") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        chrom, pos, _id, ref, alt = f[0], int(f[1]), f[2], f[3], f[4]
        filt = f[6] if len(f) > 6 else "."
        info = dict(kv.split("=", 1) for kv in (f[7].split(";") if len(f) > 7
                                                else []) if "=" in kv)
        svtype = info.get("SVTYPE", "")
        if not svtype:
            # sequence-resolved record: derive type from allele lengths
            if len(alt) > len(ref):
                svtype = "INS"
            elif len(ref) > len(alt):
                svtype = "DEL"
            else:
                continue
        end = int(info.get("END", pos))
        svlen = info.get("SVLEN")
        if svlen is not None:
            try:
                svlen = abs(int(float(svlen.split(",")[0])))
            except ValueError:
                svlen = None
        allele_resolved = (alt and alt[0] != "<" and "," not in alt
                           and (len(alt) > 1 or len(ref) > 1))
        if svlen is None:
            if allele_resolved:
                # truvari derives size from the alleles when SVLEN is absent;
                # this covers sequence-resolved DELs (len(ref) >> len(alt))
                # from PAV/assembly callsets, not just INS. Equal-length
                # alleles (sequence-resolved INVs / balanced substitutions)
                # size by the REF span, not the 0-length difference —
                # truvari's entry_size does the same; a 0 here silently
                # dropped such records at the sizemin gate.
                svlen = abs(len(alt) - len(ref)) or max(len(ref) - 1,
                                                        end - pos, 1)
            else:
                svlen = max(end - pos, 0)
        if end <= pos and svtype in ("DEL", "INV", "DUP") and svlen > 0:
            # END absent (e.g. SVLEN-only DEL records): derive the span so
            # refdist/pctovl see the real footprint, as truvari does.
            end = pos + svlen
        seq = None
        if alt and alt[0] != "<" and "," not in alt and len(alt) > 1:
            seq = alt
        gt = None
        if len(f) > sample_idx and f[8].split(":")[0] == "GT":
            gt = f[sample_idx].split(":")[0]
        comps = tuple(_canon_type(t) for t in svtype.split("+") if t)
        out.append(SvEntry(chrom, pos, end, _canon_type(svtype.split("+")[0]),
                           int(svlen), filt, seq, gt, ln,
                           comps or (_canon_type(svtype),)))
    return out


def _lcs_len(a: str, b: str) -> int:
    """Bit-parallel LCS length (Hyyro): O(len(a)*len(b)/64).

    With substitution cost 2, Levenshtein distance reduces to
    len(a)+len(b)-2*LCS, so Levenshtein.ratio == 2*LCS/(len(a)+len(b)) —
    verified exactly against python-Levenshtein on random pairs
    (tests/test_truvari_differential.py)."""
    m = len(a)
    if m == 0 or len(b) == 0:
        return 0
    alpha: Dict[str, int] = {}
    for i, ch in enumerate(a):
        alpha[ch] = alpha.get(ch, 0) | (1 << i)
    mask = (1 << m) - 1
    v = mask
    for ch in b:
        u = v & alpha.get(ch, 0)
        v = ((v + u) | (v - u)) & mask
    return m - bin(v).count("1")


def seq_ratio(a: str, b: str) -> float:
    """truvari's sequence similarity: python-Levenshtein ratio
    (sub-cost-2 edit similarity). Uses the C library when present, the
    bit-parallel LCS twin otherwise. (Round 2 used difflib's
    Ratcliff-Obershelp ratio — a documented divergence from truvari, now
    retired.)"""
    tot = len(a) + len(b)
    if tot == 0:
        return 1.0
    if _lev is not None:
        return _lev.ratio(a, b)
    return 2.0 * _lcs_len(a, b) / tot


def unroll_ratio(a: str, b: str, shift: int) -> float:
    """truvari>=4 "unroll" harmonization: two insertions placed `shift` bp
    apart inside a tandem repeat carry rotated copies of the same sequence
    — the downstream copy is the upstream one rotated LEFT by the position
    delta. `shift` is SIGNED (b.start - a.start): the upstream side is
    rotated left by |shift| % len and compared once — a single
    direction-determined rotation, exactly one comparison. (Round 3 took
    the best of direct/roll-a/roll-b — an upper bound that was mildly more
    permissive than truvari; retired in round 4. When the shift is a
    multiple of the repeat unit the rotation is the identity, so
    non-repeat pairs at identical positions are unaffected.)"""
    if not shift or not len(a) or not len(b):
        return seq_ratio(a, b)
    if shift > 0:                   # a upstream of b
        r = shift % len(a)
        return seq_ratio(a[r:] + a[:r], b)
    r = (-shift) % len(b)           # b upstream of a
    return seq_ratio(a, b[r:] + b[:r])


def _seq_similarity(a: Optional[str], b: Optional[str],
                    shift: int = 0) -> Optional[float]:
    if not a or not b:
        return None
    return unroll_ratio(a, b, shift)


def _rec_overlap(a: SvEntry, b: SvEntry) -> float:
    """Reciprocal span overlap in [0,1]; spans widened to >=1 bp."""
    a0, a1 = a.start, max(a.end, a.start + 1)
    b0, b1 = b.start, max(b.end, b.start + 1)
    inter = min(a1, b1) - max(a0, b0)
    if inter <= 0:
        return 0.0
    return inter / max(a1 - a0, b1 - b0)


def match_score(base: SvEntry, comp: SvEntry, refdist: int, pctsize: float,
                pctovl: float, pctseq: float, typeignore: bool,
                stats: Optional[Dict[str, int]] = None
                ) -> Optional[Tuple[float, int]]:
    """(score, distance) if the pair satisfies every enabled threshold."""
    if base.chrom != comp.chrom:
        return None
    dist = min(abs(base.start - comp.start), abs(base.end - comp.end))
    overlaps = (base.start <= comp.end and comp.start <= base.end)
    if dist > refdist and not overlaps:
        return None
    if not typeignore:
        if not (set(base.types) & set(comp.types)):
            return None
    terms: List[float] = []
    mx = max(base.svlen, comp.svlen)
    size_sim = (min(base.svlen, comp.svlen) / mx) if mx else 1.0
    if size_sim < pctsize:
        return None
    terms.append(size_sim)
    if base.svtype != "INS":
        ovl = _rec_overlap(base, comp)
        if ovl < pctovl:
            return None
        terms.append(ovl)
    if pctseq > 0:
        sim = _seq_similarity(base.seq, comp.seq,
                              shift=comp.start - base.start)
        if sim is None:
            # truvari scores comparisons against sequence-unresolved entries
            # as non-matching under pctseq>0 (seqsim = 0); counting them as
            # matches would silently inflate TPs for symbolic-ALT callsets.
            if stats is not None:
                stats["seq_unresolved_pairs"] = (
                    stats.get("seq_unresolved_pairs", 0) + 1)
            return None
        if sim < pctseq:
            return None
        terms.append(sim)
    return sum(terms) / len(terms), dist


def chunk_entries(base: List[SvEntry], comp: List[SvEntry],
                  chunksize: int) -> List[Tuple[List[int], List[int]]]:
    """truvari's chunking: base+comp entries are sorted together by
    (chrom, start) and an entry opens a NEW chunk when it starts more than
    `chunksize` bp past the furthest end seen in the current chunk.
    Matching happens only within a chunk. Returns (base_idx, comp_idx)
    lists per chunk (chunks with only one side present are skipped — their
    entries score no pairs, exactly like truvari's unmatched chunks)."""
    tagged = ([(e.chrom, e.start, e.end, 0, i) for i, e in enumerate(base)]
              + [(e.chrom, e.start, e.end, 1, i) for i, e in enumerate(comp)])
    tagged.sort(key=lambda t: (t[0], t[1], t[2], t[3], t[4]))
    chunks: List[Tuple[List[int], List[int]]] = []
    cur_b: List[int] = []
    cur_c: List[int] = []
    cur_chrom = None
    cur_end = -1
    for chrom, start, end, which, idx in tagged:
        if chrom != cur_chrom or start > cur_end + chunksize:
            if cur_b and cur_c:
                chunks.append((cur_b, cur_c))
            cur_b, cur_c = [], []
            cur_chrom, cur_end = chrom, end
        cur_end = max(cur_end, end)
        (cur_b if which == 0 else cur_c).append(idx)
    if cur_b and cur_c:
        chunks.append((cur_b, cur_c))
    return chunks


def bench(base_vcf: str, comp_vcf: str, *, refdist: int = 500,
          pctsize: float = 0.7, pctovl: float = 0.0, pctseq: float = 0.0,
          sizemin: int = 50, sizefilt: int = 30, sizemax: int = 50_000,
          passonly: bool = False, typeignore: bool = False,
          gt_compare: bool = False, chunksize: int = 1000) -> Dict:
    """truvari-bench-equivalent comparison of two VCFs; returns the summary
    dict (tp_base/tp_comp/fp/fn, precision/recall/f1, per-type breakdown,
    optional GT concordance over TPs)."""
    def keep(e: SvEntry, lo: int) -> bool:
        if passonly and e.filter not in ("PASS", "."):
            return False
        return lo <= e.svlen <= sizemax

    base = [e for e in parse_sv_entries(base_vcf) if keep(e, sizemin)]
    comp = [e for e in parse_sv_entries(comp_vcf) if keep(e, sizefilt)]

    # candidate pairs per chunk (truvari's chunksize grouping — with the
    # default refdist < chunksize no qualifying pair can span a chunk
    # boundary, so this is also the O(n^2) -> O(sum chunk^2) scaling that
    # makes whole-genome self-benchmarks tractable), then greedy one-to-one
    # by best score across all chunks
    gate_stats: Dict[str, int] = {}
    pairs: List[Tuple[float, int, int, int]] = []
    for b_idx, c_idx in chunk_entries(base, comp, chunksize):
        for bi in b_idx:
            b = base[bi]
            for ci in c_idx:
                sc = match_score(b, comp[ci], refdist, pctsize, pctovl,
                                 pctseq, typeignore, gate_stats)
                if sc is not None:
                    pairs.append((sc[0], sc[1], bi, ci))
    # deterministic ranking: score desc, distance asc, then entry order.
    # truvari's own tie order on equal (score, distance) pairs is
    # implementation-defined (an unstable object sort over MatchResult),
    # so no reimplementation can byte-match it; instead every run carries a
    # permutation-invariance certificate: `tie_entangled_groups` counts
    # equal-(score, distance) groups in which two candidate pairs share a
    # base or comp entry. When it is 0, every tie group's pairs are
    # endpoint-disjoint, so each pair matches iff its endpoints survived
    # the higher-ranked groups — independent of any intra-group order —
    # and TP/FP/FN/GT are provably identical under EVERY tie permutation
    # truvari could pick (property-tested in tests/test_truvari.py).
    pairs.sort(key=lambda p: (-p[0], p[1], p[2], p[3]))
    tie_entangled = 0
    i = 0
    while i < len(pairs):
        j = i
        while j < len(pairs) and pairs[j][:2] == pairs[i][:2]:
            j += 1
        if j - i > 1:
            gb = [p[2] for p in pairs[i:j]]
            gc = [p[3] for p in pairs[i:j]]
            if len(set(gb)) < len(gb) or len(set(gc)) < len(gc):
                tie_entangled += 1
        i = j
    base_hit = [False] * len(base)
    comp_hit = [False] * len(comp)
    gt_conc = 0
    matches: List[Tuple[int, int]] = []
    for _score, _dist, bi, ci in pairs:
        if base_hit[bi] or comp_hit[ci]:
            continue
        base_hit[bi] = comp_hit[ci] = True
        matches.append((bi, ci))
        if gt_compare and base[bi].gt and comp[ci].gt:
            norm = lambda g: tuple(sorted(g.replace("|", "/").split("/")))
            gt_conc += norm(base[bi].gt) == norm(comp[ci].gt)

    tp_base = sum(base_hit)
    tp_comp = sum(comp_hit)
    fn = len(base) - tp_base
    fp = len(comp) - tp_comp
    precision = tp_comp / (tp_comp + fp) if (tp_comp + fp) else 0.0
    recall = tp_base / (tp_base + fn) if (tp_base + fn) else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)

    per_type: Dict[str, Dict[str, int]] = {}
    for e, hit in zip(base, base_hit):
        d = per_type.setdefault(e.svtype, {"tp": 0, "fn": 0, "fp": 0})
        d["tp" if hit else "fn"] += 1
    for e, hit in zip(comp, comp_hit):
        if not hit:
            per_type.setdefault(e.svtype, {"tp": 0, "fn": 0, "fp": 0})["fp"] += 1

    out = dict(base_cnt=len(base), comp_cnt=len(comp), tp_base=tp_base,
               tp_comp=tp_comp, fp=fp, fn=fn,
               precision=round(precision, 4), recall=round(recall, 4),
               f1=round(f1, 4), per_type=per_type,
               tie_entangled_groups=tie_entangled,
               params=dict(refdist=refdist, pctsize=pctsize, pctovl=pctovl,
                           pctseq=pctseq, sizemin=sizemin, sizefilt=sizefilt,
                           sizemax=sizemax, passonly=passonly,
                           typeignore=typeignore, chunksize=chunksize))
    if pctseq > 0:
        out["seq_unresolved_pairs"] = gate_stats.get("seq_unresolved_pairs", 0)
    if gt_compare:
        out["gt_concordance"] = round(gt_conc / tp_base, 4) if tp_base else 0.0
    return out
