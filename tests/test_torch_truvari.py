"""The port's accuracy tooling on the CPU against the JAX package's:
svision_tpu_torch.truvari (a copy of svision_tpu/truvari.py) returns the
JAX package's exact dicts and values from bench, parse_sv_entries and
match_score, on VCF pairs built as tests/test_truvari.py builds them (the
refdist, pctsize, type, tie-group, GT and sequence cases) and on 20 seeded
random callsets; scripts/torch_truvari_bench.py prints what
scripts/truvari_bench.py prints; and scripts/torch_cohort_eval.py splits
and scores a cohort VCF that the port writes on the CPU as
scripts/cohort_eval.py does."""
import dataclasses
import importlib.util
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from svision_tpu import truvari as jax_truvari
from svision_tpu_torch import truvari

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HDR = ("##fileformat=VCFv4.2\n"
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")


def load_script(name):
    """A script of scripts/ as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vcf(tmp_path, name, rows):
    p = os.path.join(str(tmp_path), name)
    with open(p, "w") as fh:
        fh.write(HDR)
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    return p


def _row(chrom, pos, svtype, svlen, end=None, filt="PASS", gt="0/1",
         alt=None):
    end = end if end is not None else (pos + svlen if svtype != "INS"
                                       else pos)
    info = f"SVTYPE={svtype};END={end};SVLEN={svlen}"
    return (chrom, pos, ".", "N", alt or f"<{svtype}>", 30, filt, info,
            "GT", gt)


SEQ = "N" + "ACGT" * 30
PILE = [_row("chr1", 10_000, "DEL", 400), _row("chr1", 10_000, "DEL", 400)]
# name -> (base rows, comp rows, bench keyword arguments)
CASES = {
    "refdist_in": ([_row("chr1", 10_000, "DEL", 400)],
                   [_row("chr1", 10_450, "DEL", 400)], {}),
    "refdist_out": ([_row("chr1", 10_000, "DEL", 400)],
                    [_row("chr1", 11_200, "DEL", 400)], {}),
    "pctsize": ([_row("chr1", 10_000, "DEL", 1000)],
                [_row("chr1", 10_000, "DEL", 700),
                 _row("chr1", 30_000, "DEL", 600)], {}),
    "type": ([_row("chr1", 10_000, "DEL", 400)],
             [_row("chr1", 10_000, "INV", 400)], {}),
    "typeignore": ([_row("chr1", 10_000, "DEL", 400)],
                   [_row("chr1", 10_000, "INV", 400)], dict(typeignore=True)),
    "dup_family": ([_row("chr1", 10_000, "DUP", 400)],
                   [_row("chr1", 10_000, "tDUP", 400)], {}),
    "one_to_one": ([_row("chr1", 10_000, "DEL", 400),
                    _row("chr1", 10_300, "DEL", 400)],
                   [_row("chr1", 10_050, "DEL", 400)], {}),
    "tie_disjoint": ([_row("chr1", 10_000, "DEL", 400),
                      _row("chr1", 40_000, "DEL", 400)],
                     [_row("chr1", 10_050, "DEL", 400),
                      _row("chr1", 40_050, "DEL", 400)], {}),
    "tie_entangled": (PILE, PILE, {}),
    "gt": ([_row("chr1", 1_000, "DEL", 400, gt="0/1"),
            _row("chr1", 9_000, "DEL", 400, gt="1/1")],
           [_row("chr1", 1_000, "DEL", 400, gt="1/0"),
            _row("chr1", 9_000, "DEL", 400, gt="0/1")],
           dict(gt_compare=True)),
    "filters": ([_row("chr1", 10_000, "DEL", 40),
                 _row("chr1", 20_000, "DEL", 400)],
                [_row("chr1", 20_000, "DEL", 400, filt="q5")],
                dict(passonly=True)),
    "pctseq": ([_row("chr1", 10_000, "INS", 120, alt=SEQ)],
               [_row("chr1", 10_000, "INS", 120, alt="N" + "TTTT" * 30),
                _row("chr1", 10_020, "INS", 120)],
               dict(pctseq=0.7, pctovl=0.5)),
}


def random_rows(seed):
    """A caller-shaped base/comp pair: repeated sizes force score ties,
    20% of the truth is missed, 30% of it draws a spurious call."""
    rng = random.Random(seed)
    rows_b, rows_c = [], []
    pos = 10_000
    for _ in range(rng.randrange(6, 14)):
        size = rng.choice([120, 300, 400])
        typ = rng.choice(["DEL", "INS", "INV", "DUP", "tDUP"])
        gt = rng.choice(["0/1", "1/1"])
        rows_b.append(_row("chr1", pos, typ, size, gt=gt))
        if rng.random() < 0.8:
            rows_c.append(_row("chr1", pos + rng.choice([0, 30, 50, 600]),
                               typ, int(size * rng.choice([1, 0.8, 0.6])),
                               gt=rng.choice(["0/1", "1/1", "1|0"])))
        if rng.random() < 0.3:
            rows_c.append(_row("chr1", pos + 5_000, typ, size))
        pos += rng.randrange(800, 20_000)
    rng.shuffle(rows_c)
    return rows_b, rows_c


def entries(mod, path):
    return [dataclasses.asdict(e) for e in mod.parse_sv_entries(path)]


def assert_same(tmp_path, rows_b, rows_c, kw):
    base = _vcf(tmp_path, "b.vcf", rows_b)
    comp = _vcf(tmp_path, "c.vcf", rows_c)
    got, want = truvari.bench(base, comp, **kw), jax_truvari.bench(
        base, comp, **kw)
    assert got == want
    for path in (base, comp):
        assert entries(truvari, path) == entries(jax_truvari, path)
    args = (kw.get("refdist", 500), kw.get("pctsize", 0.7),
            kw.get("pctovl", 0.0), kw.get("pctseq", 0.0),
            kw.get("typeignore", False))
    for b, jb in zip(truvari.parse_sv_entries(base),
                     jax_truvari.parse_sv_entries(base)):
        for c, jc in zip(truvari.parse_sv_entries(comp),
                         jax_truvari.parse_sv_entries(comp)):
            got_s, want_s = {}, {}
            assert (truvari.match_score(b, c, *args, got_s)
                    == jax_truvari.match_score(jb, jc, *args, want_s))
            assert got_s == want_s
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_bench_equals_jax(tmp_path, case):
    rows_b, rows_c, kw = CASES[case]
    assert_same(tmp_path, rows_b, rows_c, kw)


def test_cases_cover_what_they_name(tmp_path):
    """The fixed cases reach the branches they are named after."""
    r = {c: assert_same(tmp_path, *CASES[c])
         for c in ("refdist_in", "refdist_out", "tie_entangled", "gt",
                   "pctseq")}
    assert r["refdist_in"]["tp_base"] == 1 and r["refdist_out"]["fn"] == 1
    assert r["tie_entangled"]["tie_entangled_groups"] >= 1
    assert r["gt"]["gt_concordance"] == 0.5
    assert r["pctseq"]["seq_unresolved_pairs"] >= 1


@pytest.mark.parametrize("seed", range(20))
def test_random_callsets_equal_jax(tmp_path, seed):
    rows_b, rows_c = random_rows(seed)
    kw = dict(gt_compare=bool(seed % 2), typeignore=seed % 5 == 0)
    assert_same(tmp_path, rows_b, rows_c, kw)


def test_truvari_bench_script_prints_jax_scripts_line(tmp_path, capsys,
                                                      monkeypatch):
    rows_b, rows_c = random_rows(7)
    base = _vcf(tmp_path, "b.vcf", rows_b)
    comp = _vcf(tmp_path, "c.vcf", rows_c)
    flags = ["--gt", "--refdist", "800", "--pctsize", "0.5"]
    load_script("torch_truvari_bench").main([base, comp] + flags)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["truvari_bench.py", base, comp] + flags)
    load_script("truvari_bench").main()
    assert got == capsys.readouterr().out
    assert json.loads(got)["tp_base"] > 0


@pytest.fixture(scope="module")
def cohort_vcf(tmp_path_factory):
    """A two-sample cohort VCF from the port on the CPU, and its events."""
    from svision_tpu_torch import sim
    from svision_tpu_torch.cli import RunOptions
    from svision_tpu_torch.models.alexnet import init_params
    from svision_tpu_torch.models.checkpoint import save_params
    from svision_tpu_torch.parallel import cohort
    root = tmp_path_factory.mktemp("torch_cohort_eval")
    genome = str(root / "ref.fa")
    seqs = sim.make_genome(genome, {"chr1": 80000}, seed=21)
    events = [("DEL", "chr1", 20000, 250), ("INS", "chr1", 50000, 180)]
    bams = {}
    for name, seed, evs in (("A", 1, events[:1]), ("B", 2, events)):
        bams[name] = str(root / f"{name}.bam")
        sim.make_sv_bam(bams[name], seqs, seed=seed, support=6, events=evs)
    weights = str(root / "w.npz")
    save_params(init_params(0), weights)
    out = root / "out"
    out.mkdir()
    vcf = cohort.run_cohort(bams, RunOptions(
        out_path=str(out), genome=genome, model_path=weights, min_support=3,
        batch_size=16, device="cpu").normalized())
    eventsf = str(root / "events.json")
    with open(eventsf, "w") as fh:
        json.dump(events, fh)
    return vcf, eventsf


def test_split_by_sample_equals_jax_script(cohort_vcf):
    vcf, _ = cohort_vcf
    got = load_script("torch_cohort_eval").split_by_sample(vcf)
    want = load_script("cohort_eval").split_by_sample(vcf)
    assert got == want
    assert set(got) == {"A", "B"} and got["B"]


def test_cohort_eval_prints_jax_scripts_scores(cohort_vcf, capsys,
                                               monkeypatch):
    vcf, eventsf = cohort_vcf
    load_script("torch_cohort_eval").main([vcf, eventsf])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["cohort_eval.py", vcf, eventsf])
    load_script("cohort_eval").main()
    assert got == capsys.readouterr().out
    scores = json.loads(got)
    assert np.isfinite(scores["B"]["recall"])
