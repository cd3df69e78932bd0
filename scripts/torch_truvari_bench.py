"""CLI for the first-party truvari-style SV benchmarker, from the PyTorch
port (svision_tpu_torch.truvari, a copy of the JAX package's module).

Usage:
  python scripts/torch_truvari_bench.py BASE.vcf COMP.vcf [--refdist 500]
      [--pctsize 0.7] [--pctovl 0.0] [--pctseq 0.0] [--sizemin 50]
      [--sizemax 50000] [--passonly] [--typeignore] [--gt]

Prints a truvari-bench-style JSON summary, the same as
scripts/truvari_bench.py: point BASE at the truth VCF and COMP at the
pipeline output. Scoring runs on the host; nothing here touches a device.
For bgzipped inputs, decompress first (svision_tpu_torch.io.bgzf.BgzfReader
or zcat).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from svision_tpu_torch.truvari import bench  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("base")
    ap.add_argument("comp")
    ap.add_argument("--refdist", type=int, default=500)
    ap.add_argument("--pctsize", type=float, default=0.7)
    ap.add_argument("--pctovl", type=float, default=0.0)
    ap.add_argument("--pctseq", type=float, default=0.0)
    ap.add_argument("--sizemin", type=int, default=50)
    ap.add_argument("--sizefilt", type=int, default=30)
    ap.add_argument("--sizemax", type=int, default=50_000)
    ap.add_argument("--passonly", action="store_true")
    ap.add_argument("--typeignore", action="store_true")
    ap.add_argument("--gt", action="store_true", help="GT concordance on TPs")
    ap.add_argument("--chunksize", type=int, default=1000,
                    help="max reference distance to group calls for "
                         "matching (truvari chunking)")
    a = ap.parse_args(argv)
    print(json.dumps(bench(
        a.base, a.comp, refdist=a.refdist, pctsize=a.pctsize,
        pctovl=a.pctovl, pctseq=a.pctseq, sizemin=a.sizemin,
        sizefilt=a.sizefilt, sizemax=a.sizemax, passonly=a.passonly,
        typeignore=a.typeignore, gt_compare=a.gt,
        chunksize=a.chunksize), indent=2))


if __name__ == "__main__":
    main()
