"""Read/overlap utility tools (the port's copy of necat_tpu/pipeline/tools.py):
the fsa_rd_tools / fsa_rd_stat / fsa_rd_extract / oc2slstats / oc2pprr /
oc2slr command families, on the host; none takes a device.

  python -m necat_tpu_torch.pipeline.tools n50     <reads.fa[.gz]>
  python -m necat_tpu_torch.pipeline.tools stats   <reads.fa[.gz]>           # oc2slstats
  python -m necat_tpu_torch.pipeline.tools longest <in> <out> <genome_size> <coverage>
  python -m necat_tpu_torch.pipeline.tools split   <in> <out_prefix> <n_parts>
  python -m necat_tpu_torch.pipeline.tools extract <in> <out> <start> <count>
  python -m necat_tpu_torch.pipeline.tools preprocess <in> <out> [min_length]  # oc2pprr
  python -m necat_tpu_torch.pipeline.tools simulate <out> <genome_size> <coverage> [seed]  # oc2slr-style
  python -m necat_tpu_torch.pipeline.tools m4topaf <in.m4[.gz]> <out.paf>
  python -m necat_tpu_torch.pipeline.tools split_name <in> <out_prefix> <n_parts>
  python -m necat_tpu_torch.pipeline.tools check   <reads.fa[.gz]>

(reference: src/fsa/read_tools.cpp:26-41 Running, src/fsa/read_stat.cpp:30-45,
src/fsa/read_extract.cpp:34-152, src/sequence_length_stats/main.c,
src/preprocess_raw_reads/, src/split_long_reads/main.c:12-30)
"""

from __future__ import annotations

import sys

import numpy as np

from necat_tpu_torch.io.readstore import ReadStore
from necat_tpu_torch.io import simulate as sim
from necat_tpu_torch.overlap.m4 import M4Records
from necat_tpu_torch.utils.dust import is_nonrepeat_sequence


def cmd_n50(args):
    rs = ReadStore.from_fasta(args[0])
    n50, n = rs.n50()
    print(f"reads\t{rs.n_reads}")
    print(f"bases\t{rs.total_bases}")
    print(f"N50\t{n50}")
    print(f"L50\t{n}")


def cmd_stats(args):
    rs = ReadStore.from_fasta(args[0])
    ls = np.sort(rs.lengths)[::-1]
    tot = ls.sum()
    c = np.cumsum(ls)
    out = {"count": rs.n_reads, "bases": int(tot),
           "min": int(ls[-1]) if len(ls) else 0, "max": int(ls[0]) if len(ls) else 0,
           "mean": int(ls.mean()) if len(ls) else 0,
           "median": int(np.median(ls)) if len(ls) else 0}
    for p in (25, 50, 75):
        i = int(np.searchsorted(c, tot * p / 100))
        out[f"N{p}"] = int(ls[min(i, len(ls) - 1)]) if len(ls) else 0
    for k, v in out.items():
        print(f"{k}\t{v}")


def cmd_longest(args):
    inp, outp, gs, cov = args[0], args[1], int(float(args[2])), float(args[3])
    rs = ReadStore.from_fasta(inp)
    keep = rs.longest_to_coverage(gs, cov)
    rs.subset(keep).to_fasta(outp)
    print(f"kept {len(keep)}/{rs.n_reads} reads")


def cmd_split(args):
    inp, prefix, n = args[0], args[1], int(args[2])
    rs = ReadStore.from_fasta(inp)
    per = -(-rs.n_reads // n)
    for i in range(n):
        sub = rs.subset(np.arange(i * per, min((i + 1) * per, rs.n_reads)))
        sub.to_fasta(f"{prefix}.{i}.fasta")
    print(f"wrote {n} parts")


def cmd_extract(args):
    inp, outp, start, count = args[0], args[1], int(args[2]), int(args[3])
    rs = ReadStore.from_fasta(inp)
    sub = rs.subset(np.arange(start, min(start + count, rs.n_reads)))
    sub.to_fasta(outp)
    print(f"extracted {sub.n_reads} reads")


def cmd_preprocess(args):
    """oc2pprr + oc2renumberSeqs: validate/renumber reads, min-length filter,
    and drop near-all-repeat reads via DUST masking
    (src/preprocess_raw_reads/main.c + check_nonrepeat_suffix.cpp)."""
    inp, outp = args[0], args[1]
    min_len = int(args[2]) if len(args) > 2 else 0
    rs = ReadStore.from_fasta(inp, min_length=min_len)
    keep = np.array([is_nonrepeat_sequence(rs.get(i)) for i in range(rs.n_reads)])
    n_dropped = int((~keep).sum())
    if n_dropped:
        rs = rs.subset(np.flatnonzero(keep))
    rs.names = [str(i + 1) for i in range(rs.n_reads)]  # renumber (oc2renumberSeqs)
    rs.to_fasta(outp)
    print(f"{rs.n_reads} reads ({n_dropped} repeat reads dropped)")


def cmd_simulate(args):
    outp, gs, cov = args[0], int(float(args[1])), float(args[2])
    seed = int(args[3]) if len(args) > 3 else 0
    genome = sim.random_genome(gs, seed=seed)
    reads, *_ = sim.simulate_reads(genome, coverage=cov, seed=seed + 1)
    ReadStore.from_seqs(reads).to_fasta(outp)
    print(f"wrote {len(reads)} reads")


def cmd_split_name(args):
    """fsa_rd_tools split_name: partition reads into n parts and write the NAME
    lists (read_tools.cpp SplitName); part files are <prefix>.<i>.txt."""
    inp, prefix, n = args[0], args[1], int(args[2])
    rs = ReadStore.from_fasta(inp)
    per = -(-rs.n_reads // n)
    for i in range(n):
        lo, hi = i * per, min((i + 1) * per, rs.n_reads)
        with open(f"{prefix}.{i}.txt", "w") as f:
            for j in range(lo, hi):
                f.write(rs.names[j] + "\n")
    print(f"wrote {n} name lists")


def cmd_check(args):
    """fsa_rd_tools check: validate that a FASTA/FASTQ parses, has unique names
    and only ACGTN bases (read_tools.cpp Check role)."""
    rs = ReadStore.from_fasta(args[0])
    dup = len(rs.names) - len(set(rs.names))
    bad = int((rs.bases > 3).sum())
    ok = dup == 0 and bad == 0
    print(f"reads\t{rs.n_reads}\nduplicate_names\t{dup}\nnon_acgt_codes\t{bad}\n"
          f"status\t{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(1)


def cmd_m4topaf(args):
    m4 = M4Records.load(args[0])
    with open(args[1], "w") as f:
        for i in range(len(m4)):
            qoff, qend = m4.qoff[i], m4.qend[i]
            if m4.qdir[i] == 1:  # PAF uses forward query coords + strand char
                qoff, qend = m4.qsize[i] - m4.qend[i], m4.qsize[i] - m4.qoff[i]
            strand = "-" if m4.qdir[i] != m4.sdir[i] else "+"
            alen = max(int(m4.qend[i] - m4.qoff[i]), int(m4.send[i] - m4.soff[i]))
            nmatch = int(alen * m4.ident[i] / 100.0)
            f.write(f"{m4.qid[i]}\t{m4.qsize[i]}\t{qoff}\t{qend}\t{strand}\t"
                    f"{m4.sid[i]}\t{m4.ssize[i]}\t{m4.soff[i]}\t{m4.send[i]}\t"
                    f"{nmatch}\t{alen}\t60\n")
    print(f"wrote {len(m4)} PAF records")


COMMANDS = {
    "n50": cmd_n50, "stats": cmd_stats, "longest": cmd_longest,
    "split": cmd_split, "extract": cmd_extract, "preprocess": cmd_preprocess,
    "simulate": cmd_simulate, "m4topaf": cmd_m4topaf,
    "split_name": cmd_split_name, "check": cmd_check,
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
