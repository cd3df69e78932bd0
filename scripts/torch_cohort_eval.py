"""Score a multi-sample cohort VCF (svision_tpu_torch.parallel.cohort's
output) per sample, with the PyTorch port's copy of the scorer.

Splits the merged VCF into per-sample call views -- a record counts for
sample k when its SUPP_VEC bit k is set, carrying that sample's GT column --
and scores each view against the planted truth with
svision_tpu_torch.evaluate.score_calls (breakpoint resolution included).
The same as scripts/cohort_eval.py; host code only.

Usage:
    python scripts/torch_cohort_eval.py merged.vcf events.json [genotypes.json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svision_tpu_torch.evaluate import score_calls  # noqa: E402


def split_by_sample(vcf_path):
    """{sample_name: [call dicts]} from a cohort VCF."""
    samples = []
    per = {}
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("##"):
                continue
            f = line.rstrip("\n").split("\t")
            if line.startswith("#CHROM"):
                samples = f[9:]
                per = {s: [] for s in samples}
                continue
            info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
            vec = info.get("SUPP_VEC", "1" * len(samples))
            types = set(t for t in info.get("SVTYPE", "").split("+") if t)
            lens = {}
            for part in info.get("BKPS", "").split(","):
                if ":" in part:
                    t, rest = part.split(":", 1)
                    types.add(t)
                    try:
                        lens.setdefault(t, int(rest.split("-", 1)[0]))
                    except ValueError:
                        pass
            fmt = f[8].split(":")
            gt_i = fmt.index("GT") if "GT" in fmt else None
            for k, s in enumerate(samples):
                if k < len(vec) and vec[k] != "1":
                    continue
                gt = "./."
                if gt_i is not None and 9 + k < len(f):
                    gt = f[9 + k].split(":")[gt_i]
                per[s].append(dict(chrom=f[0], pos=int(f[1]),
                                   end=int(info.get("END", f[1])),
                                   types=types, lens=lens, qual=f[5],
                                   filter=f[6], gt=gt))
    return per


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    vcf, eventsf = argv[0], argv[1]
    gtf = argv[2] if len(argv) > 2 else None
    with open(eventsf) as fh:
        events = [tuple(e) for e in json.load(fh)]
    gts = None
    if gtf:
        with open(gtf) as fh:
            gts = json.load(fh)
    out = {}
    for sample, calls in split_by_sample(vcf).items():
        r = score_calls(calls, events, tol=1500, truth_gt=gts)
        out[sample] = {
            "n_calls": r["n_calls"], "recall": r["recall"],
            "precision": r["precision"],
            "gt_concordance": r.get("gt_concordance"),
            "gt_eval": r.get("gt_eval"),
            "bkp_dpos": r["bkp"]["dpos"],
            "strict_recall": r.get("strict_recall"),
        }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
