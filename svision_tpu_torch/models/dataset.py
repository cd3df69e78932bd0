"""Labeled training data from simulated SVs.

The reference ships inference only — its checkpoint was trained offline on
curated images (README.md:85-86) and is distributed out-of-band. A complete
framework must be able to bootstrap its own model, so this module closes the
data loop: simulate a genome + reads carrying typed SV events, run the REAL
collection stage (signatures -> clusters -> candidate pairs), and label each
emitted candidate spec with the planted event's class.

Class ids follow the reference decoder (predict.py:133-142):
0=DEL 1=INS 2=INV 3=DUP 4=tDUP.

Candidate selection per event type mirrors how the prediction decoder
consumes pairs (predict.py:278-294) AND how refine_type reconciles them
(output.py:352-467): DEL/INS/INV are learned from the pair kinds that carry
them in the decoder; for duplications (DUP and tDUP) the class lives on the
main-x-other pair whose segments OVERLAP on the reference axis (the
dup-channel discriminator, plot_segment.py:57-67), while the main-main pair
of the same signature is geometrically identical to an insertion pair
(diagonal, read-gap, no ref overlap) and is labeled INS — at call time the
decoder predicts INS on it, tDUP/DUP on the overlap pair, and refine_type
collapses the {INS, dup} combo into the dup call, exactly the reference's
design. (Round-2 forensics: labeling the pixel-identical mm pairs tDUP
capped train accuracy at ~0.85 and caused the small-event INS<->tDUP
confusions — the two classes genuinely shared images.)
"""

from __future__ import annotations

import os
import random
import tempfile
from typing import List, Sequence, Tuple

import numpy as np

CLASS_IDS = {"DEL": 0, "INS": 1, "INV": 2, "DUP": 3, "tDUP": 4}
CLASS_NAMES = {v: k for k, v in CLASS_IDS.items()}


def simulate_events(n_per_type: int, seed: int = 0, spacing: int = 24000,
                    start: int = 30000,
                    kinds: Sequence[str] = ("DEL", "INS", "INV", "DUP",
                                            "tDUP"),
                    size_range: Tuple[int, int] = (120, 600)):
    """Evenly-spaced typed events along chr1, shuffled order, random sizes."""
    rng = random.Random(seed)
    order = [k for k in kinds for _ in range(n_per_type)]
    rng.shuffle(order)
    events = []
    pos = start
    for kind in order:
        size = rng.randint(*size_range)
        if kind == "INV+DEL":
            # independent deletion size, kept CLEAR of the reference's
            # structural blind spot: an INV+DEL main-main pair has
            # ref-gap/read-gap = (il+dl)/il, and linearOrNot
            # (output_clusters.py:11-26) deletes pairs with ratio <= 1.5
            # as colinear — deletions below ~il/2 next to an inversion are
            # invisible to the reference DESIGN, and dl == il/2 exactly
            # (the old coupled default) flip-flops on noise jitter.
            # Round-4 forensics: docs/PERF.md.
            dl = rng.randint(int(0.65 * size) + 20, size + 100)
            events.append((kind, "chr1", pos, size, dl))
        elif kind == "DEL+INS":
            # ratio dl/il must stay out of [0.7, 1.5] (the same colinear
            # band); the historical il/2 default sits at 0.5 — keep the
            # deletion below 0.6*il, varied
            dl = rng.randint(60, max(61, int(0.6 * size)))
            events.append((kind, "chr1", pos, size, dl))
        else:
            events.append((kind, "chr1", pos, size))
        pos += spacing
    return events, pos + spacing


def collect_candidates(events, chrom_len: int, workdir: str, seed: int = 0,
                       support: int = 8, min_support: int = 3,
                       profile=None):
    """Simulate genome+BAM for `events`, run the collection stage, return
    (candidates, genome_path, bam_path). profile: a noise.NoiseProfile /
    "hifi"/"ont" — train on reads with realistic error structure."""
    from svision_tpu_torch.sim import make_genome, make_sv_bam
    from svision_tpu_torch.cli import parse_arguments
    from svision_tpu_torch.collect.window import run_detect

    genome_path = os.path.join(workdir, "ref.fa")
    bam_path = os.path.join(workdir, "sim.bam")
    seqs = make_genome(genome_path, {"chr1": chrom_len}, seed=seed)
    make_sv_bam(bam_path, seqs, seed=seed, support=support, events=events,
                profile=profile)
    options = parse_arguments(
        ["-o", os.path.join(workdir, "out"), "-b", bam_path,
         "-g", genome_path, "-m", "unused.npz", "-n", "sim",
         "-s", str(min_support)])
    os.makedirs(options.out_path, exist_ok=True)
    result = run_detect(options, bam_path, "chr1", 0, 0, chrom_len)
    if result.error:
        raise RuntimeError(f"collection failed: {result.error}")
    return result.candidates, genome_path, bam_path


def label_candidates(candidates, events, tol: int = 5000):
    """Match candidates to planted events by region midpoint; emit
    (specs [N,12] int64, labels [N] int32). Unmatched candidates and pair
    kinds that don't carry the event's class are dropped."""
    anchors = np.array([e[2] for e in events])
    kinds = [e[0] for e in events]
    specs: List[Tuple[int, ...]] = []
    labels: List[int] = []
    for cand in candidates:
        try:
            _, cstart, cend, _ = cand.region.split("+")
            cstart, cend = int(float(cstart)), int(float(cend))
        except ValueError:
            continue
        mid = (cstart + cend) / 2
        i = int(np.argmin(np.abs(anchors - mid)))
        if abs(anchors[i] - mid) > tol:
            continue
        kind = kinds[i]
        main_main = "m" in cand.sig_id
        if kind in ("DUP", "tDUP"):
            if main_main:
                # the insertion-backbone pair: pixel-identical to an INS
                # image (diagonals + read gap, no ref overlap). The decoder
                # predicts INS here and refine_type folds {INS, dup} into
                # the dup call (output.py:352-467) — so its true image
                # class IS INS.
                kind = "INS"
            else:
                # the dup carrier: segments overlap on the ref axis, which
                # is what lights the duplication channel. Skip stray
                # non-overlapping other-pairs.
                s = cand.spec
                y_overlap = min(s[3], s[8]) - max(s[2], s[7])
                if y_overlap <= 0:
                    continue
        elif kind == "INV":
            # the reversed segment is 'other' (strand-discordant ->
            # minor_segs, analyze_reads.py:680-684); the colinear main pair
            # is dropped by linearOrNot, so INV lives on reverse pairs
            if cand.pair_forward != "False":
                continue
        elif kind == "INV+DEL":
            # compound curriculum: the mm pair carries BOTH a read gap
            # (the inverted span) and a LARGER ref gap (inversion +
            # deletion) — its image class is DEL (net reference loss; the
            # decoder must call DEL here for the <CSV> combo to carry the
            # DEL component); the reverse mo pairs are the INV carriers.
            # Without these, noisy mm pairs fall between the clean INS
            # (read gap only) and DEL (ref gap only) clusters — the
            # round-4 noisy-loop INV+DEL recall regression.
            if main_main:
                kind = "DEL"
            elif cand.pair_forward == "False":
                kind = "INV"
            else:
                continue
        elif not main_main:
            continue
        specs.append(tuple(cand.spec))
        labels.append(CLASS_IDS[kind])
    return (np.array(specs, dtype=np.int64).reshape(-1, 12),
            np.array(labels, dtype=np.int32))


def balance_classes(specs: np.ndarray, labels: np.ndarray, seed: int = 0):
    """Downsample every class to the smallest class count (INV events emit
    two pairs per read, skewing the raw distribution)."""
    rng = np.random.RandomState(seed)
    counts = [int((labels == c).sum()) for c in range(5)]
    floor = min(c for c in counts if c > 0)
    keep: List[int] = []
    for c in range(5):
        idx = np.flatnonzero(labels == c)
        if len(idx) > floor:
            idx = rng.choice(idx, floor, replace=False)
        keep.extend(idx.tolist())
    keep = np.sort(np.array(keep, dtype=np.int64))
    return specs[keep], labels[keep]


def build_dataset(n_per_type: int = 40, seed: int = 0, support: int = 8,
                  min_support: int = 3, workdir: str = None,
                  tol: int = 5000, balance: bool = True,
                  size_range: Tuple[int, int] = (120, 600),
                  profile=None,
                  kinds: Sequence[str] = ("DEL", "INS", "INV", "DUP",
                                          "tDUP")):
    """Simulate + collect + label; returns (specs, labels, events)."""
    import contextlib
    events, chrom_len = simulate_events(n_per_type, seed=seed,
                                        size_range=size_range, kinds=kinds)
    if workdir is None:
        ctx = tempfile.TemporaryDirectory()
    else:
        os.makedirs(workdir, exist_ok=True)
        ctx = contextlib.nullcontext(workdir)
    with ctx as wd:
        cands, _, _ = collect_candidates(events, chrom_len, wd, seed=seed,
                                         support=support,
                                         min_support=min_support,
                                         profile=profile)
        specs, labels = label_candidates(cands, events, tol=tol)
    if balance and len(labels):
        specs, labels = balance_classes(specs, labels, seed=seed)
    return specs, labels, events


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="svision-tpu training-set builder (simulated SVs)")
    ap.add_argument("-o", dest="out", required=True,
                    help="output .npz (specs + labels)")
    ap.add_argument("--n-per-type", type=int, default=40)
    ap.add_argument("--support", type=int, default=8)
    ap.add_argument("--min-support", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args(argv)
    specs, labels, _ = build_dataset(n_per_type=ns.n_per_type, seed=ns.seed,
                                     support=ns.support,
                                     min_support=ns.min_support)
    np.savez(ns.out, specs=specs, labels=labels)
    counts = {CLASS_NAMES[c]: int((labels == c).sum()) for c in range(5)}
    print(f"saved {ns.out}: {len(labels)} examples {counts}")


if __name__ == "__main__":
    main()
